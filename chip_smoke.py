#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port (``sparsebase_tpu_torch``) on one card.

    python3 chip_smoke.py [--nnz 100e6] [--band-nnz 64e6] [--rcm-n 65536] [--ingest-nnz 32e6]
                          [--feature-n 4000000] [--seed 0]

(``--path-m-child DIR`` makes the script one process of path M's group;
path M starts it so.)

Phases, in order; any failure raises and the script exits non-zero:

0. needs ``torch.cuda.is_available()``; prints the card's name and power
   limit (``nvidia-smi``);
1. builds the kernels from ``sparsebase_tpu_torch/csrc`` (nvcc, sm_90a)
   and, at the same time, the fastio and graphkit host libraries (g++);
   either host library failing to build stops the run here;
2. K7 (a label-propagation round) against its plain version on the card, at
   edge shapes: k = 2, 8, 64, 4,096 and 8,192, past its shared-memory
   tier, a row of 262,144 entries, every third row empty, no entries,
   integer-valued and real weights, ids one element off 16-byte alignment;
   both sides of its tier edges: n * k = nnz (the cells stored) and one
   part more (two passes), k = 8 (registers) and 9, k = 255 (1-byte
   gathers) and 256; every vertex in one part at k = 8 and 64; labels
   outside [0, k); the penalty's weight at 0.1 and 1; these tier cases
   draw from a generator of their own, so that a case added there leaves
   every path's graph as it was. The edge cases of K1–K6 are cases of
   ``tests/test_torch_cuda.py``;
3. the slice's paths, each once, with every launch count set to 0 just
   before it and read just after: path A, ``preprocess_pipeline`` on a
   ``--nnz`` COO made on the device (uniform rows, columns 20% from
   [0, n/100), row-major sorted, duplicates kept; n = nnz/16); path B, a
   banded COO (33 diagonals, ``--band-nnz`` stored entries) through
   ``convert(CSR)``, ``convert(DIA)`` and ``spmv(dia, x)``; path C, the op
   API on path A's COO: ``convert(CSR)``, ``DegreeReorder(ascending=False)``,
   ``permute_2d`` with a seeded random column order and with rows only,
   ``spmv``; path D, path B's band at ``--rcm-n`` rows under a seeded
   random symmetric permutation (``COO.new`` sorts it again) through
   ``convert(CSR)``, ``RCMReorder``, ``permute_2d(csr, order, order)``,
   ``convert(DIA)`` and ``spmv(dia, x)``, then ``rcm_pipeline`` on the same
   COO; path E, a ``--ingest-nnz`` COO made as path A's (n = nnz/16),
   written by ``IOBase.write_coo_to_mtx(coo, path, symmetry="symmetric")``
   (its lower triangle) to a temporary directory, read back onto the card by
   ``IOBase.read_pigo_mtx_to_coo`` (fastio's parse on the host; the
   mirror and ``COO.new``'s sort, K5, on the card), through
   ``preprocess_pipeline`` and, on a clone, ``preprocess_pipeline_donating``,
   then ``IOBase.write_csr_to_binary`` and ``IOBase.read_binary_to_csr``;
   path F, a random graph of ``--feature-n`` vertices (``n * 8`` uniform
   pairs with u != v, mirrored, the first sixteenth of those entries again,
   4,096 self-loops; ``COO.new``'s sort, K5) through ``convert(CSR)`` and
   one ``GraphFeatureBase.extract`` of the 17 reference features that are
   not fused classes (the extractor fuses them back): the column features
   through ``convert(CSC)`` (K5, K3), ``JaccardWeights`` and the undirected
   ``TriangleCount`` through K6; path G, the reorderers on path A's COO:
   ``convert(CSR)`` (K3), ``GrayReorder`` (K5), ``BOBAReorder`` on the COO
   (K5), ``DegreeReorder`` (K5) and ``ReorderHeatmap(8).get_heatmap_with_stats``
   under the natural, degree, Gray and BOBA orders, then SlashBurn (k = 8),
   AMD, nested dissection and Rabbit through ``ReorderBase.reorder`` by name
   on a power-law graph of 32,768 vertices on the card (host algorithms:
   graphkit on a host copy, the order back on the card); path H, partitioning:
   ``models.partition_pipeline`` on path A's COO (k = 8, 10 rounds: K3, K7
   once a round, K5, K4, K2) and on a planted graph of the same size
   (``planted_coo``: path A's rows, 8 blocks of equal size, 95% of the
   entries inside their row's block, the ids shuffled), the counts set to
   0 before and read after each of the two calls, then ``PulpPartition``
   (graphkit, and with ``use_graphkit`` off, so that K7 runs inside it),
   ``MetisPartition`` (kway and rb) and ``PatohPartition``, k = 8, on path
   G's power-law graph of 32,768 vertices on the card; path I, the harness:
   a graph made as path E's written as a symmetric MTX file, the
   reference's ``custom_experiment`` on it (``ConcreteExperiment(warmup=1)``,
   ``load_csr`` onto the card, ``pass_preprocess`` and ``reorder_csr`` of
   ``DegreeReorder``, ``GrayReorder`` and ``BOBAReorder``, the kernels
   ``spmv`` on ones (K2) and ``JaccardWeights`` (K6), three reps), the
   dashboard of the loaded CSR (``Visualizer``, 64 buckets, the degree,
   Gray and BOBA orderings and the CLI's feature cards; counts, then
   ``|values|``), the visualizer's CLI on the file in a subprocess on the
   card, and ``bench_suite.run_matrix`` on rand-20k on the card (mesh-90k,
   30 s of host algorithms, runs apart: ``python -m
   sparsebase_tpu_torch.bench_suite --matrix "mesh-90k(scrambled)"``);
   path J, the distributed tier on a single-process mesh of four shards
   that share the one card (``make_mesh(devices=[cuda:0] * 4)``), on path
   A's COO and source CSR: ``ShardedCSR.from_coo_sharded`` (route: K5 and
   K3 over the owners; local sort K5, ``indptr`` K3) and ``with_halo``
   (K5, K3), ``from_csr`` at d = 4 and d = 1, ``dist.spmv`` (K2 per
   shard), every replicated function of ``dist`` (``degrees``,
   ``degree_reorder``, ``bfs_levels`` from 0, ``rcm_reorder``,
   ``label_prop_partition`` with k = 8 and 10 rounds, ``edge_cut``,
   ``refine_partition`` with 4 rounds, ``structure_features``,
   ``reorder_heatmap`` with b = 8) at d = 4 and at d = 1, beside them every
   function of ``halo`` (``spmv``, K2 per shard on its ``halo_map``
   columns; ``bfs_levels`` from 0; ``rcm_reorder``, K5 and K3 in each
   counting rank; ``label_prop_partition``; ``edge_cut``;
   ``refine_partition``, K5 and K3 in each admission;
   ``connected_components``) at d = 4 and at d = 1, and
   ``Sharded2DCSR.from_csr`` (K5, K3) on a 2×2 mesh of the card with its
   ``spmv`` (K2 per tile, ``psum_scatter``) and ``degrees``; path K, the
   multilevel half of ``halo`` on path J's meshes, at d = 4 and d = 1:
   ``heavy_edge_matching`` (weighted and on the pattern), ``coarsen`` with
   its map (the route: K5, K3) and ``multilevel_partition`` (k = 8) on path
   A's generator over 8 disjoint blocks (a quarter of path A's entries
   before mirroring; half until path O joined the script), mirrored;
   ``bfs_levels_multilevel`` from 0 and ``rcm_reorder_ml`` (K5) on path B's
   band scrambled; ``slashburn_reorder`` (K5 and K3 in each counting rank)
   on ``POWER_LAW_CARD``'s graph mirrored without repeats, k = 1% of its
   vertices, ``hub_order`` off and on, and on ``POWER_LAW_HOST``'s with its
   defaults and with every host tier and compaction off; path L, the rings
   (``parallel.ring``) on a mesh of four shards of the card and on d = 1,
   each graph ingested by ``from_coo_sharded`` (K5, K3) and its oracles,
   K6 on the whole CSR (``TriangleCount``, directed too, and
   ``JaccardWeights``): 128 disjoint cliques K_512 with shuffled ids (the
   dense ``triangle_count`` and ``jaccard_flat`` at d = 4, 2^30 tile cells
   a shard, ``MAX_DENSE_ELEMS`` exactly; the cliques with each pair
   oriented by a coin, ``triangle_count(directed=True)`` at d = 4, and at
   d = 1 its ``ValueError``), a uniform simple graph of 65,536 vertices (16
   pairs a vertex, mirrored; both rings' four functions at d = 4, the
   guard's sparse route at d = 1), ``POWER_LAW_CARD``'s graph mirrored
   without repeats (``triangle_count`` and ``jaccard_flat`` at d = 4 and
   d = 1, the sparse ring; a uniform graph of 2^20 vertices went when path
   P took the sparse ring at 2^22 across processes), and
   ``bench_suite.run_distributed(shards=4)``; path M,
   the distributed ingest's path across processes: ``tools/multiproc_dcn.py``'s
   graph at 2^22 vertices, average degree 8 (made on the card from
   ``--seed`` by a generator of its own, so every process makes the same)
   through ``ShardedCSR.from_coo_sharded`` (K5, K3), ``with_halo`` (K5,
   K3), ``halo.spmv`` (K2 per shard) and ``dist.rcm_reorder`` (K5) on one
   process of four shards of the card, then on two gloo processes of this
   script (``--path-m-child``, started by ``multihost.launch`` under a
   time limit) that share the card, each driving two shards of
   ``multihost.global_mesh(devices=[cuda:0] * 2)``; with two or more cards
   also on two NCCL processes with a card each; path N, inside path M's
   processes, the twelve functions of ``dist`` and ``halo`` that run
   across processes since then (``dist.spmv``, K2 per shard;
   ``label_prop_partition``, ``edge_cut``, ``refine_partition``, K5;
   ``structure_features``, ``reorder_heatmap``; ``halo.bfs_levels``,
   ``label_prop_partition``, ``connected_components``, ``rcm_reorder`` and
   ``refine_partition``, K5 and K3 in each counting rank and admission;
   ``edge_cut``) on path M's container, first in the one process of four
   shards, then in both processes; path O, after path N in the same
   processes, ``halo``'s multilevel half, SlashBurn and the containers cut
   from a CSR: ``heavy_edge_matching`` (weighted) and ``coarsen`` with its
   map (the route: K5, K3; ``with_halo``) on path M's container,
   ``ShardedCSR.from_csr`` and ``from_csr_balanced`` (K5 in the deal, K4
   in the permutation) of path M's CSR, ``bfs_levels_multilevel`` from 0
   and ``rcm_reorder_ml`` down to ``PATH_O_COARSEN_UNTIL`` vertices and
   ``multilevel_partition`` (k = 8, its defaults) on ``tool_graph`` at
   ``PATH_O_N`` = 2^17 vertices (from ``--seed`` + 1), and
   ``slashburn_reorder`` (k = ``PATH_O_SLASHBURN_K``, ``host_tail_nnz=0``,
   ``hub_order`` off and on: rounds on the mesh, compactions through
   ``from_csr``, graphkit's host tail) on ``POWER_LAW_HOST``'s graph
   mirrored without repeats, first in the one process, then in both; path
   P, after path O in the same processes, the rings, ``sharded2d``, the
   containers and the harness: the dense ring (``triangle_count``,
   ``jaccard_flat``; ``triangle_count(directed=True)`` on the cliques with
   each pair oriented by a coin; bfloat16 tiles cross the processes) on 32
   disjoint cliques K_512 (``PATH_P_CLIQUES``, from ``--seed`` + 2, by
   ``from_coo_sharded``: K5, K3), the sparse ring (``triangle_count`` and
   ``jaccard_flat``; the owner sort K5, the segments K3) on path M's
   container, ``Sharded2DCSR.from_csr`` (K5, K3 per tile) of path M's CSR
   on a 2×2 mesh (``multihost.global_mesh_2d`` in the group) with its axes
   either way round, its ``spmv`` (K2 per tile) and ``degrees``,
   ``ShardedCSR.stacked`` of ``indptr`` and ``nnz_local`` and ``to`` the
   mesh and the card's context, the suite's ``run_distributed`` (in the
   group only) and an experiment of ``load_sharded_csr``,
   ``distributed_reorder("rcm")`` and ``distributed_spmv_kernel`` (K2) on
   rand-20k, written by the parent as an MTX file into the group's
   directory, first in the one process, then in both. Every kernel of each
   path must have launched, in each process of paths M, N, O and P too;
4. checks of path A (indptr, per-row column order, degree order, the
   permuted CSR equal bit for bit to the plain relocation, ``y`` against
   the plain SpMV of the permuted matrix), of path B (K1 against K2 and
   against its plain version) and of path C (``ro`` and both permuted CSRs
   equal to their plain versions, ``y`` against the plain SpMV); K5 with no
   host sync; the (row, column) sort of path A's entries, shuffled, by K5 on
   the packed 64-bit keys equal to a stable ``torch.sort``; K4's route for
   rows over 4,096 entries (one K5 launch) equal to the plain relocation on
   a graph with power-law row degrees; of path
   D, every reference built from the plain ``indptr`` of path D's COO (the
   CSR's K3 ``indptr`` equal to it; ``_symmetrized_square``, K5 and K3,
   equal to the CPU route's at full size; the order is a permutation; at
   16,384 rows the card's order equals the device route run on CPU copies;
   the RCM'd band has at most 65 diagonals; K4's ``permute_2d`` equal to
   the plain relocation; K1 on the band against its plain version and,
   mapped back, against K2 on the scrambled CSR; K2 against the plain
   SpMV; ``rcm_pipeline`` against the plain relocation and SpMV; CSR → CSC
   → CSR equal to the source; ELL SpMV against the plain SpMV;
   ``permute_2d`` of the ELL equal to the plain relocation; a second call of
   what ``RCMReorder`` runs giving the same order, with at most one host
   sync per BFS level step); of path E (the COO read back equal, in
   canonical order, to the source's lower triangle mirrored by plain torch
   ops, values exactly; K5's sort in ``COO.new`` equal to the plain sort;
   the read staged (the host parse, the copy to the card, the device steps)
   equal to the read; the pipeline's outputs passing path A's checks;
   the donating variant's equal to the plain pipeline's; the SBFF round trip
   ``torch.equal`` on every array; at about 100,000 lines the numpy reader,
   the Pigo reader and ``Graph.read_connectivity_from_mtx_to_coo`` agreeing
   on the card; ``ReorderBase.reorder("degree")`` equal to ``DegreeReorder``
   on the card and ``ReorderBase.reorder("rcm")`` on the host (graphkit)
   equal to ``_rcm_host``); of path F (K6 against its plain version at full
   size, the Jaccard weights bit for bit and the triangle sum exactly;
   every other feature against the same feature on a CPU copy, integers and
   ``DegreeDistribution`` exactly, the float64 column statistics within
   1e-12 relative, the column features on the card's CSC, whose ``indptr``
   is first held to the host's column counts; the directed ``TriangleCount``
   of path F's graph (K6's directed mode, past the dense wall) equal to its
   plain version and to twice the undirected count; K6 in its undirected
   modes on ``phase_long_rows``'s power-law graph mirrored, and in directed
   mode on the same graph unmirrored with 4,096 self-loops, against its plain
   version, and on the same generator cut to 100,000 rows and 800,000
   entries against graphkit's ``jaccard`` and ``triangles`` and the torch
   ``_directed_count`` on host copies; at 16,384 vertices, with self-loops,
   the dense tier equal to K6 and graphkit undirected, and to K6's directed
   mode, to the same pattern as 16,385 vertices and to the host routes
   directed; K_512 giving C(512, 3) on both tiers and twice that directed;
   ``FillIn`` of a CUDA CSR of a 33-diagonal band at 131,072 rows equal to
   its closed form); of path G (the Gray and BOBA orders and each heatmap
   grid and stats equal to the port's CPU route on host copies of the full
   graph; each order a permutation, int32 on the card; each grid summing to 1
   within 1e-5 and its stats equal to a recount; Gray and BOBA with no host
   sync, so nothing of theirs left the card, the heatmap with at most three
   (``bincount``'s and the stats' reads); each host reorderer's order
   int32 on the card and equal to the same call on a CPU copy); of path H
   (on both graphs: the labels equal to ten rounds through K7's plain
   version on the card, int32 in [0, 8); the permuted CSR equal to the plain
   relocation under the labels' stable rank, ``y`` against the plain SpMV;
   ten rounds of ``_propagate`` with no host sync; part sizes, balance and
   the edge cut before and after, and against the planted cut; each
   partitioner's labels int32 on the card, equal to
   the same call on a CPU copy, with K7 launched by Pulp without graphkit
   only); of path I (24 run times keyed in the JAX order; the loaded CSR
   equal to the source's mirrored lower triangle; each reordered matrix
   equal to the plain relocation under its order, the order equal to the
   CPU route on host copies; ``spmv`` per row against the plain SpMV of its
   matrix, the same bits on every rep; ``jaccard`` equal to K6 called
   directly (and K6 to its plain version) on ``pass``, and to the source's
   weights carried through the order on a reordered matrix; a kernel that
   enqueues 50 ms of ``torch.cuda._sleep`` recorded at 50 ms or more,
   returning a CUDA tensor or ``None``; a kernel that raises makes ``run()``
   raise; one traced run's Chrome trace naming its scope, an
   ``sbtorch:op:`` span and K2's device kernels; each dashboard grid and its stats equal to
   ``ReorderHeatmap`` on host copies, the ``|values|`` grids of two orders to
   a float64 ``np.add.at`` at rtol 1e-12, four sections, the CLI's file equal
   to the in-process HTML; the suite's rand-20k entry equal, but for its
   times, to ``run_matrix`` on a CPU copy); of path J (the ingest's shards
   hold ``from_csr``'s entries shard by shard, in canonical order, with the
   same ``indptr`` and counts, and the widths the JAX formulas give;
   ``with_halo`` equal to the host builder ``_build_halo`` on path G's
   32,768-vertex power-law graph at d = 4 and d = 8; ``dist.spmv`` and the
   2-D SpMV within the per-row bound of K2 on the whole CSR and of the
   plain SpMV; every replicated result the same at d = 4 and d = 1 bit for
   bit, and against plain versions: degrees from ``indptr``, the degree
   order a stable argsort rank, the levels a torch-op level BFS, the RCM
   order a (level, degree, id) rank by stable argsorts, the edge cut a
   count of the labels, the bandwidth and profile the features'
   ``Bandwidth`` and ``Profile``, the heatmap ``ReorderHeatmap``'s at rtol
   1e-6; the refined cut no higher than the labels'; with four or more
   cards, the ingest's shards and ``dist.spmv`` on ``make_mesh(4)`` equal
   to one card's; ``halo.spmv`` within
   the per-row bound of K2 on the whole CSR, at d = 4 and d = 1; every
   integer ``halo`` result the same at d = 4 and d = 1, ``halo.bfs_levels``
   equal to ``dist.bfs_levels`` and the plain level BFS, ``halo.edge_cut``
   to ``dist.edge_cut`` of the same labels, ``halo.rcm_reorder`` a
   permutation in reverse level order from the root a plain
   pseudo-peripheral search finds (that root last among the reached, each
   BFS level one range, the unreached after), the labels in [0, 8), and
   where the labels fed to refinement fit the cap, its cut no higher and
   its parts within the cap; ``halo.connected_components`` on path A's
   generator over 8 disjoint blocks, mirrored (half path A's entries
   before mirroring), equal to a plain min-label fixpoint, whole and with
   the 1% of vertices of highest degree masked out, at d = 4 and d = 1,
   each component inside one block); of path K (every integer result the
   same at d = 4 and d = 1 bit for bit; both matchings involutions along
   entries; the coarse graph equal to a plain torch contraction of its map
   as a multiset of entries; the partition's labels in [0, 8) within the
   1.1 cap, its cut printed beside the planted 0 and label propagation with
   refinement's; every vertex of the band reached, the RCM order a
   permutation, the levels' error against the closed-form exact levels and
   the bandwidths printed; each SlashBurn order a permutation, the card
   graph's first k positions its k highest-degree vertices of the giant
   component, ids ascending on ties, and the host graph's orders equal to
   graphkit's ``slashburn(greedy=False)``); of path L (the cliques'
   2,846,556,160 triangles, K6's count, every weight 510/512 and K6's bit
   for bit, the directed count K6's; on the other graphs every count
   equal to K6's, dense, sparse, d = 4 and d = 1, and every weight K6's
   bit for bit; the suite's table on the card equal, but for its times, to
   the same call on the CPU); of path M (one process's y against the plain
   SpMV of the whole CSR, its order equal to the plain (level, degree, id)
   rank of a plain BFS from 0; each process's ``nnz_counts``, route
   capacity, ``w_c``, widths and halo bytes, every one of its shards'
   ``indptr``, ``indices``, ``vals``, ``nnz_local``, ``halo_send``,
   ``halo_counts`` and ``halo_map``, and its y and RCM order equal to the
   one process's bit for bit; a process that fails or passes the time
   limit fails the run); of path N (one process's ``dist.spmv`` against the
   plain SpMV, ``halo.bfs_levels`` equal to ``dist.bfs_levels``,
   ``halo.edge_cut`` to ``dist.edge_cut`` of the same labels and
   ``dist.edge_cut`` to a plain count, the structure features to the host
   features, the heatmap to ``ReorderBase.heatmap``, the components to the
   plain fixpoint, the RCM order reversed level-major from the plain
   peripheral root, every refinement of a labelling within the cap kept
   within it at no higher cut; each process's every result, floats with
   ``torch.equal``, and ``stats`` equal to the one process's bit for bit);
   of path O (one process's matching an involution along entries, the
   coarse CSR equal to a plain contraction by the map in canonical order,
   ``from_csr(...).to_csr()`` equal to the source CSR and
   ``from_csr_balanced``'s to ``ReorderBase.permute2d(order, src)``, the
   multilevel BFS reaching the plain BFS's vertices, the multilevel RCM a
   permutation, the partition's labels in [0, 8) within the cap, SlashBurn's
   orders equal to ``native.slashburn(greedy=False)``; each process's every
   result, its own shards of every container field by field, and
   ``stats`` equal to the one process's bit for bit); of path P (one
   process's counts and weights equal to K6's on the whole CSR, the
   cliques' count to its closed form, both orientations' y against the
   plain SpMV of path M's CSR and their degrees equal to
   ``dist.degrees``, the stacked fields and both moves equal to the
   container's fields, the experiment's y against the plain SpMV of its
   file and its order a permutation; each process's every result, its own
   shards and tiles, by the SHA-256 of their bytes, equal to the one
   process's, and its ``run_distributed`` table, but for its times, equal
   to path L's);
5. the kernel table (PERF.md §6), on the inputs the checks built: each
   kernel's one call between two CUDA events (the wrapper's host time
   included), its device time per call under ``torch.profiler`` (three
   calls, the profiler held open 5 s either side; K2–K5 from a profile of path A's call, K1 from path B's and from
   the tiled layout's own, K6 in Jaccard mode on path F's graph, K7's first
   round on path A's graph), its plain version, its bound and, where one
   PyTorch call computes the same function, that call (``library_ms``:
   cuSPARSE through ``torch.mv`` on a ``sparse_csr_tensor`` for K2, first
   held to K2's per-row bound; ``torch.searchsorted`` for K3; a stable
   ``torch.argsort`` for K5), which the package never makes. K1 and K2
   run on path B's band and path A's CSR, K3 on path A's row ids, K4 on
   path A's CSR under its degree rank (rows and columns), K5 on path A's
   degrees.

Paths D to M run their phases 3 and 4 in turn after those of paths A–C,
path N, O and P inside path M's (each process runs path N after path M,
then path O, then path P); phase 5 runs last. Whole paths are timed by
``benchmark/run.py``, not here.

The agreement of an SpMV kernel with its plain version is held per row to
``|y_k - y_p| <= 4 * deg_i * eps_f32 * (|A| |x|)_i``, which bounds two f32
sums of the same terms taken in different orders. K3, K4, K5 and K6 compute
exact results and must equal their plain versions (``torch.equal``; K6's
Jaccard weights are one rounding of an exact quotient). K7's labels equal
its plain version's where the counts are integers; with real weights a row
may differ only where its two best scores lie within 8 ulp.

A kernel's bound (``bound_ms``) is ``benchmark/core/bounds.py``'s: the
larger of the bytes its function must move (each input read once, each
output written once) over the H100's 3.35 TB/s and its floating-point
operations over the 67 TFLOP/s f32 rate outside the tensor cores (data
sheet, SXM, 700 W). K6's compares are integer operations: its bytes
(:func:`common_neighbors_bytes`) bound it, and no single PyTorch call
computes its function (``library_ms`` null); nor K7's.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

from benchmark.core.bounds import HBM_BYTES_PER_S, bound
from benchmark.core.trace import count_host_syncs, kernel_table, profile_calls

EPS_F32 = torch.finfo(torch.float32).eps
BAND_HALF_WIDTH = 16  # 33 diagonals
REPO = Path(__file__).resolve().parent


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def check_rows(name: str, y, y_ref, deg, absdot) -> float:
    """Per-row agreement within the reordered-f32-sum bound; returns the
    largest absolute difference."""
    err = (y.to(torch.float32) - y_ref.to(torch.float32)).abs()
    bound = 4.0 * deg.to(torch.float32) * EPS_F32 * absdot.to(torch.float32)
    over = int((err > bound).sum())
    max_err = float(err.max()) if err.numel() else 0.0
    print(f"  {name}: rows={y.numel()} max_abs_err={max_err:.6g} rows_over_bound={over}")
    check(bool(torch.isfinite(y).all()), f"{name}: non-finite output")
    check(over == 0, f"{name}: {over} rows disagree beyond the bound")
    return max_err


def cuda_ms(fn, batch: int = 1, reps: int = 5) -> float:
    """Median time in ms of one call of ``fn`` between two CUDA events, after
    one warm-up: the host's time in the call is included where the device
    waits for it. With ``batch`` calls back to back per event pair (the time
    per call), the host's time is hidden behind the previous call's device
    work."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


# -- inputs, made on the device from a seed ----------------------------------
def dia_row_degrees(dia):
    n, m = dia.shape
    i = torch.arange(n, device=dia.data.device)
    j = i[None, :] + dia.offsets.to(torch.int64)[:, None]
    return ((j >= 0) & (j < m)).sum(dim=0)


def power_law_coo(g, dev, n, nnz):
    """Rows uniform, columns 20% from a clump [0, n/100), row-major sorted,
    duplicates kept (the benchmark graph of bench.py)."""
    from sparsebase_tpu_torch import COO
    from sparsebase_tpu_torch.convert.kernels import sort_by_pairs_plain

    row = torch.randint(0, n, (nnz,), generator=g, device=dev, dtype=torch.int32)
    clump = torch.randint(0, max(n // 100, 1), (nnz,), generator=g, device=dev, dtype=torch.int32)
    col = torch.randint(0, n, (nnz,), generator=g, device=dev, dtype=torch.int32)
    col = torch.where(torch.rand((nnz,), generator=g, device=dev) < 0.2, clump, col)
    del clump
    vals = torch.randn((nnz,), generator=g, device=dev)
    row, col, vals = sort_by_pairs_plain(row, col, vals)
    return COO(row, col, vals, (n, n))


def power_law_csr(g, dev, n, nnz):
    """A CSR whose row degrees follow ``power_law_degrees``, with uniform
    column ids and random values (sorted within rows only by chance)."""
    from sparsebase_tpu_torch import CSR
    from sparsebase_tpu_torch.convert.kernels import indptr_from_counts

    indptr = indptr_from_counts(power_law_degrees(g, dev, n, nnz))
    total = int(indptr[-1])
    cols = torch.randint(0, n, (total,), generator=g, device=dev, dtype=torch.int32)
    return CSR(indptr, cols, torch.randn((total,), generator=g, device=dev), (n, n))


def power_law_degrees(g, dev, n, nnz):
    """Row degrees proportional to 1 / (1 + rank), scaled to about ``nnz``
    entries in all and shuffled over the rows: a few rows hold a large share
    of the entries."""
    weight = 1.0 / torch.arange(1, n + 1, device=dev, dtype=torch.float64)
    deg = torch.floor(weight * (nnz / float(weight.sum()))).to(torch.int64)
    return deg[torch.randperm(n, generator=g, device=dev)]


def banded_coo(g, dev, band_nnz):
    """A square matrix with every entry of diagonals -16..16 stored."""
    from sparsebase_tpu_torch import COO

    k = 2 * BAND_HALF_WIDTH + 1
    n = band_nnz // k
    offs = torch.arange(-BAND_HALF_WIDTH, BAND_HALF_WIDTH + 1, device=dev)
    i = torch.arange(n, device=dev)[:, None]
    j = i + offs[None, :]
    ok = (j >= 0) & (j < n)
    row = i.expand_as(j)[ok].to(torch.int32)  # row-major walk: already sorted
    col = j[ok].to(torch.int32)
    del i, j, ok
    vals = torch.randn((row.numel(),), generator=g, device=dev)
    return COO(row, col, vals, (n, n))


def scrambled_band(g, dev, n, with_perm: bool = False):
    """``banded_coo``'s band of ``n`` rows under a seeded random symmetric
    permutation, row-major sorted again by ``COO.new`` (K5 on the card);
    with ``with_perm`` also the permutation (``perm[p]`` is the vertex at
    band position p)."""
    from sparsebase_tpu_torch import COO

    band = banded_coo(g, dev, n * (2 * BAND_HALF_WIDTH + 1))
    perm = torch.randperm(n, generator=g, device=dev).to(torch.int32)
    coo = COO.new(perm[band.row], perm[band.col], band.vals, band.shape)
    return (coo, perm) if with_perm else coo


def abs_csr(csr):
    from sparsebase_tpu_torch import CSR

    return CSR(csr.indptr, csr.indices, None if csr.vals is None else csr.vals.abs(), csr.shape)


# -- phases ------------------------------------------------------------------
def phase_device() -> torch.device:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    return torch.device("cuda", 0)


def phase_build() -> None:
    """The kernels (nvcc) and the two host libraries (g++) built at once; a
    host library that does not build stops the run before any work."""
    from concurrent.futures import ThreadPoolExecutor

    from sparsebase_tpu_torch import _build, native
    from sparsebase_tpu_torch.io import fastio

    def seconds(fn):
        t0 = time.perf_counter()
        return fn(), time.perf_counter() - t0

    with ThreadPoolExecutor(2) as pool:
        host = {name: pool.submit(seconds, lib.available) for name, lib in (("fastio", fastio), ("graphkit", native))}
        _, cuda_s = seconds(_build.library)
        host = {name: job.result() for name, job in host.items()}
    print(f"phase 1 build and load: {cuda_s:.2f} s -> {_build.build()}")
    for name, (ok, s) in host.items():
        check(ok, f"the {name} library did not build (g++; its output is logged above)")
        print(f"phase 1 host library {name} (g++) build and load: {s:.2f} s")


def check_equal(name: str, got, want) -> None:
    """Exact agreement of an integer-result kernel with its plain version."""
    same = got.shape == want.shape and got.dtype == want.dtype and torch.equal(got, want)
    print(f"  {name}: n={want.numel()} equal={same}")
    check(same, f"{name}: kernel and plain version differ")


def check_csr_equal(name: str, got, want) -> None:
    for field in ("indptr", "indices", "vals"):
        a, b = getattr(got, field), getattr(want, field)
        if b is None:
            check(a is None, f"{name}: {field} should be None")
        else:
            check_equal(f"{name} {field}", a, b)


def library_spmv(csr, x):
    """``(name, fn)``: cuSPARSE's CSR SpMV through one PyTorch call on the
    same matrix (int32 offsets and ids), built here, outside any timing."""
    a = torch.sparse_csr_tensor(csr.indptr.to(torch.int32), csr.indices, csr.vals, csr.shape,
                                check_invariants=False)
    try:
        torch.mv(a, x)
        return "torch.mv(sparse_csr_tensor)", lambda: torch.mv(a, x)
    except (RuntimeError, NotImplementedError) as exc:
        print(f"  torch.mv refused the sparse CSR tensor ({exc}); timing a @ x[:, None]")
        return "sparse_csr_tensor @ x[:, None]", lambda: (a @ x[:, None]).squeeze(1)


def phase_pair_sort(g, coo) -> None:
    """The (row, column) sort of a COO's entries, shuffled: K5 on the packed
    64-bit keys with the sorted keys returned, against the stable
    ``torch.sort`` it stands in for."""
    from sparsebase_tpu_torch.ops.kernels import radix_argsort
    from sparsebase_tpu_torch.ops.kernels.radix import bits_below

    shuffle = torch.randperm(coo.nnz, generator=g, device=coo.row.device)
    key = (coo.row[shuffle].to(torch.int64) << 32) | coo.col[shuffle].to(torch.int64)
    del shuffle
    key_bits = [(0, bits_below(coo.ncols)), (32, 32 + bits_below(coo.nrows))]
    perm, sorted_keys = radix_argsort(key, key_bits, return_keys=True)
    want_keys, want_perm = torch.sort(key, stable=True)
    check_equal("pair sort K5 vs torch.sort: permutation", perm, want_perm.to(torch.int32))
    check_equal("pair sort K5 vs torch.sort: keys", sorted_keys, want_keys)


def phase_long_rows(g, dev, n: int = 1_000_000, nnz: int = 16_000_000) -> None:
    """K4's route for rows of more than 4,096 entries, which sorts them with
    K5 on a (row, new column) key, on a graph whose row degrees follow a
    power law."""
    from sparsebase_tpu_torch import _build
    from sparsebase_tpu_torch.ops.kernels import relocate_csr, relocate_csr_plain

    csr = power_law_csr(g, dev, n, nnz)
    ro = torch.randperm(n, generator=g, device=dev).to(torch.int32)
    before = _build.launch_counts()["radix_rank"]
    got = relocate_csr(csr, ro, ro)
    k5_launches = _build.launch_counts()["radix_rank"] - before
    check(k5_launches == 1, f"rows over 4,096 entries launched K5 {k5_launches} times, expected once")
    check_csr_equal("K4 power-law rows (ro, ro)", got, relocate_csr_plain(csr, ro, ro))


class PathD:
    """Path D: a scrambled band through ``convert(CSR)``, ``RCMReorder``,
    ``permute_2d(csr, order, order)``, ``convert(DIA)`` and ``spmv(dia, x)``;
    then ``rcm_pipeline`` on the same COO."""

    SMALL_N = 16_384  # rows of the band whose order is also computed on the CPU

    def __init__(self, g, dev, n, seed):
        from sparsebase_tpu_torch import CSR
        from sparsebase_tpu_torch.ops.reorder import RCMReorder

        self.coo = scrambled_band(g, dev, n)
        self.x = torch.randn((n,), generator=g, device=dev)
        self.co = torch.randperm(n, generator=g, device=dev).to(torch.int32)
        self.small = scrambled_band(torch.Generator(device=dev).manual_seed(seed), dev, self.SMALL_N).convert(CSR)
        self.small_order = RCMReorder().get_reorder(self.small)

    def run(self):
        from sparsebase_tpu_torch import CSR, DIA, spmv
        from sparsebase_tpu_torch.ops.permute import permute_2d
        from sparsebase_tpu_torch.ops.reorder import RCMReorder

        csr = self.coo.convert(CSR)
        order = RCMReorder().get_reorder(csr)
        banded = permute_2d(csr, order, order)
        dia = banded.convert(DIA)
        x_band = torch.empty_like(self.x)
        x_band[order] = self.x  # x in the reordered space
        return csr, order, banded, dia, x_band, spmv(dia, x_band)


def phase_path_d_checks(d: PathD, csr, order, banded, dia, x_band, y_band, pipe) -> float:
    """Every kernel of path D against its plain version on path D's own
    tensors, with references built from the plain ``indptr``, not from K3's;
    returns K1's largest difference from its plain version."""
    from sparsebase_tpu_torch import CSC, CSR, ELL, spmv
    from sparsebase_tpu_torch.ops.kernels import csr_spmv, csr_spmv_plain, dia_spmv_plain, indptr_plain
    from sparsebase_tpu_torch.ops.kernels import relocate_csr_plain
    from sparsebase_tpu_torch.ops.permute import permute_2d
    from sparsebase_tpu_torch.ops.reorder.rcm import _rcm_device, _symmetrized_square

    n = d.coo.nrows
    print(f"phase 4 path D checks: n={n} stored entries={d.coo.nnz}; the RCM'd band has {dia.num_diagonals} "
          f"diagonals (bandwidth {dia.bandwidth}; 33 expected, at most 65 allowed)")
    src = CSR(indptr_plain(d.coo.row, n), d.coo.col, d.coo.vals, d.coo.shape)
    check_csr_equal("path D convert(CSR) (K3 indptr) vs plain", csr, src)
    sym = _symmetrized_square(csr)
    sym_host = _symmetrized_square(src.to_host())  # torch.sort and the plain indptr on the CPU
    check_csr_equal("path D _symmetrized_square (K5 pair sort, K3) vs the CPU route", sym.to_host(), sym_host)
    del sym, sym_host
    check(bool((torch.bincount(order.long(), minlength=n) == 1).all()), "path D: the RCM order is not a permutation")
    check(dia.num_diagonals <= 65, f"path D: {dia.num_diagonals} diagonals after RCM, more than 65")
    on_cpu = _rcm_device(_symmetrized_square(d.small.to_host()))
    check_equal("path D RCM order at 16,384 rows, card vs the device route on CPU copies", d.small_order.cpu(), on_cpu)
    check_csr_equal("path D permute_2d(csr, order, order) (K4) vs plain relocation", banded,
                    relocate_csr_plain(src, order, order))
    band_deg = dia_row_degrees(dia)
    band_absdot = dia_spmv_plain(dia.offsets, dia.data.abs(), x_band.abs(), dia.shape)
    err_k1 = check_rows("path D K1 on the RCM'd band vs plain", y_band,
                        dia_spmv_plain(dia.offsets, dia.data, x_band, dia.shape), band_deg, band_absdot)
    y_src = csr_spmv_plain(src, d.x)
    absdot = csr_spmv_plain(abs_csr(src), d.x.abs())
    y_k2 = csr_spmv(csr, d.x)
    check_rows("path D K2 on the scrambled CSR vs plain", y_k2, y_src, src.degrees(), absdot)
    check_rows("path D K1 on the RCM'd band (mapped back) vs K2 on the scrambled CSR", y_band[order.long()], y_k2,
               src.degrees(), absdot)
    permuted, y_pipe = pipe
    # the band's pattern is symmetric: its out-edges and A ∪ Aᵀ (each edge
    # twice, every degree doubled) give the device route the same order
    ro = order
    check_csr_equal("path D rcm_pipeline permuted CSR vs plain relocation", permuted, relocate_csr_plain(src, ro, ro))
    y_ref = torch.empty_like(y_src)
    y_ref[ro] = y_src
    absdot_ro = torch.empty_like(absdot)
    absdot_ro[ro] = absdot
    deg_ro = torch.empty_like(src.degrees())
    deg_ro[ro] = src.degrees()
    check_rows("path D rcm_pipeline y vs plain SpMV", y_pipe, y_ref, deg_ro, absdot_ro)
    back = csr.convert(CSC).convert(CSR)
    check_csr_equal("path D CSR -> CSC -> CSR vs the source", back, src)
    ell = csr.convert(ELL)
    check_rows("path D spmv(ELL) vs plain", spmv(ell, d.x), y_src, src.degrees(), absdot)
    check_csr_equal("path D permute_2d(ell, ro, co) -> CSR vs plain relocation",
                    permute_2d(ell, order, d.co).convert(CSR), relocate_csr_plain(src, order, d.co))
    # the level steps and host syncs of what RCMReorder runs on a square
    # CUDA CSR, in one call whose order must be the main path's
    stats, out = {}, []
    syncs = count_host_syncs(lambda: out.append(_rcm_device(_symmetrized_square(csr), stats=stats)))
    check_equal("path D RCM order, a second call vs the main path's", out[0], order)
    steps = stats["level_steps"]
    print(f"  path D RCM device route: {steps} BFS level steps, {syncs} host syncs in one call of "
          "_symmetrized_square and _rcm_device")
    check(syncs <= steps, f"path D: the RCM device route synced the host {syncs} times in {steps} level steps")
    return err_k1


def path_d(g, dev, n: int, seed: int):
    """Path D's phases 3 and 4, run after paths A–C. Returns its two runs'
    launch counts, summed, and K1's largest difference from its plain
    version on the recovered band."""
    from sparsebase_tpu_torch import _build

    from sparsebase_tpu_torch import rcm_pipeline

    d = PathD(g, dev, n, seed)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    csr, order, banded, dia, x_band, y_band = d.run()
    launches = read_launches("D", ("indptr", "radix_rank", "relocate_csr", "banded_spmv"))
    _build.reset_launch_counts()
    pipe = rcm_pipeline(d.coo, d.x)
    launches_pipe = read_launches("D rcm_pipeline", ("indptr", "relocate_csr", "csr_spmv"))
    err_k1 = phase_path_d_checks(d, csr, order, banded, dia, x_band, y_band, pipe)
    return {k: launches[k] + launches_pipe[k] for k in launches}, err_k1


def canonical_entries(row, col, vals):
    """The entries sorted by (row, column, value): duplicates' payloads in
    one order, whatever order a sort left them in."""
    order = torch.argsort(vals, stable=True)
    key = (row.to(torch.int64) << 32) | col.to(torch.int64)
    order = order[torch.argsort(key[order], stable=True)]
    return row[order], col[order], vals[order]


def mirrored_lower(src):
    """``(row, col, vals)`` of what a symmetric MTX of ``src`` reads back as:
    its lower triangle, mirrored, by plain torch ops (the diagonal once)."""
    low = src.row >= src.col
    lr, lc, lv = src.row[low], src.col[low], src.vals[low]
    off = lr != lc
    return torch.cat([lr, lc[off]]), torch.cat([lc, lr[off]]), torch.cat([lv, lv[off]])


def check_read_back(label: str, got, mirrored) -> None:
    """The entries ``got`` (row, col, vals) equal ``mirrored`` exactly, both
    in canonical order."""
    from sparsebase_tpu_torch.convert.kernels import sort_by_pairs_plain

    got = canonical_entries(*got)
    want = canonical_entries(*sort_by_pairs_plain(*mirrored))
    for name, a, b in zip(("row", "col", "vals"), got, want):
        check_equal(f"{label} {name} vs the source's mirrored lower triangle", a.to(b.dtype), b)


def check_pipeline_outputs(label: str, coo, x, permuted, y) -> None:
    """Path A's checks of ``preprocess_pipeline``'s outputs on ``coo``."""
    from sparsebase_tpu_torch import CSR
    from sparsebase_tpu_torch.ops.kernels import csr_spmv_plain, indptr_plain, radix_rank_plain, relocate_csr_plain

    n, nnz = coo.nrows, coo.nnz
    src = CSR(indptr_plain(coo.row, n), coo.col, coo.vals, coo.shape)
    ip = permuted.indptr
    check(ip.shape == (n + 1,) and int(ip[0]) == 0 and int(ip[-1]) == nnz, f"{label}: permuted indptr ends")
    check(bool((ip[1:] >= ip[:-1]).all()), f"{label}: permuted indptr is not monotone")
    check(permuted.is_sorted(), f"{label}: permuted columns are not sorted within rows")
    check(bool((permuted.degrees()[1:] >= permuted.degrees()[:-1]).all()), f"{label}: rows not in ascending degree order")
    ro = radix_rank_plain(src.degrees())
    check_csr_equal(f"{label} permuted CSR vs plain relocation", permuted, relocate_csr_plain(src, ro, ro))
    x_new = torch.empty_like(x)
    x_new[ro] = x
    check_rows(f"{label} y vs plain SpMV of the permuted matrix", y, csr_spmv_plain(permuted, x_new),
               permuted.degrees(), csr_spmv_plain(abs_csr(permuted), x_new.abs()))


class PathE:
    """Path E: a COO written as a symmetric MTX file, read back onto the card
    by the Pigo reader, taken through ``preprocess_pipeline`` (and its
    donating variant on a clone), written as SBFF and read back."""

    SMALL_NNZ = 166_000  # source entries of the file read three ways: about 100,000 lines

    def __init__(self, g, dev, nnz: int, workdir: str):
        self.n = max(nnz // 16, 1)
        self.src = power_law_coo(g, dev, self.n, nnz)
        self.x = torch.randn((self.n,), generator=g, device=dev)
        self.small = power_law_coo(g, dev, max(self.SMALL_NNZ // 16, 1), self.SMALL_NNZ)
        self.mtx = f"{workdir}/path_e.mtx"
        self.sbff = f"{workdir}/path_e.sbff"
        self.small_mtx = f"{workdir}/small.mtx"

    def run(self):
        from sparsebase_tpu_torch import COO, IOBase, preprocess_pipeline, preprocess_pipeline_donating

        IOBase.write_coo_to_mtx(self.src, self.mtx, symmetry="symmetric")
        coo = IOBase.read_pigo_mtx_to_coo(self.mtx)
        pipe = preprocess_pipeline(coo, self.x)
        clone = COO(coo.row.clone(), coo.col.clone(), coo.vals.clone(), coo.shape)
        donated = preprocess_pipeline_donating(clone, self.x)
        del clone  # consumed
        IOBase.write_csr_to_binary(donated[0], self.sbff)
        return coo, pipe, donated, IOBase.read_binary_to_csr(self.sbff)


def phase_path_e_checks(e: PathE, coo, pipe, donated, back) -> None:
    """Path E's checks: the read-back COO against the source's lower triangle
    mirrored by plain torch ops; K5's sort in ``COO.new`` against the plain
    sort; the read staged (the host parse, the host-to-device copy, the
    device steps) against the read; both pipelines against path A's checks
    and each other; the SBFF round trip; three readers at 100,000 lines;
    ``ReorderBase`` against the direct calls."""
    import os

    from sparsebase_tpu_torch import CSR, Graph, IOBase, ReorderBase
    from sparsebase_tpu_torch.convert.kernels import sort_by_pairs, sort_by_pairs_plain
    from sparsebase_tpu_torch.io import PigoMTXReader
    from sparsebase_tpu_torch.ops.reorder import DegreeReorder
    from sparsebase_tpu_torch.ops.reorder.rcm import _rcm_host, _symmetrized_square

    print(f"phase 4 path E checks: n={e.n}, source entries {e.src.nnz}, read back {coo.nnz}")
    mr, mc, mv = mirrored_lower(e.src)
    check(coo.nnz == mr.numel() and coo.row.dtype == torch.int32 and coo.vals.dtype == torch.float32,
          f"path E read back {coo.nnz} entries of {coo.row.dtype}/{coo.vals.dtype}, expected {mr.numel()} int32/float32")
    check_read_back("path E read-back COO", (coo.row, coo.col, coo.vals), (mr, mc, mv))
    k5 = sort_by_pairs(mr, mc, mv, major_bound=coo.nrows, minor_bound=coo.ncols)
    plain = sort_by_pairs_plain(mr, mc, mv)
    for name, a, b in zip(("row", "col", "vals"), k5, plain):
        check_equal(f"path E COO.new's sort (K5) vs the plain sort: {name}", a, b)
    del k5, plain, mr, mc, mv
    reader = PigoMTXReader(e.mtx)
    row, col, vals, shape = reader.parse()
    row, col, vals = (t.to(coo.row.device) for t in (row, col, vals))
    again = reader._assemble(row, col, vals, shape, stable_payload=False)
    for name in ("row", "col", "vals"):
        check_equal(f"path E staged read vs IOBase.read_pigo_mtx_to_coo: {name}", getattr(again, name),
                    getattr(coo, name))
    del reader, row, col, vals, again
    permuted, y = pipe
    check_pipeline_outputs("path E pipeline", coo, e.x, permuted, y)
    d_perm, d_y = donated
    for name in ("indptr", "indices", "vals"):
        check_equal(f"path E donating vs plain pipeline: {name}", getattr(d_perm, name), getattr(permuted, name))
    check_equal("path E donating vs plain pipeline: y", d_y, y)
    for name in ("indptr", "indices", "vals"):
        check_equal(f"path E SBFF round trip: {name}", getattr(back, name), getattr(d_perm, name))
    on_card = e.src.row.device.type
    check(back.shape == d_perm.shape and back.indptr.device.type == on_card, "path E SBFF round trip: shape or device")
    del permuted, y
    # three readers at about 100,000 lines
    IOBase.write_coo_to_mtx(e.small, e.small_mtx, symmetry="symmetric")
    with open(e.small_mtx, "rb") as f:
        lines = sum(1 for _ in f) - 2
    routes = {"numpy": IOBase.read_mtx_to_coo(e.small_mtx), "pigo": IOBase.read_pigo_mtx_to_coo(e.small_mtx),
              "Graph": Graph.read_connectivity_from_mtx_to_coo(e.small_mtx).connectivity}
    for route, c in routes.items():
        check(c.row.device.type == on_card, f"path E {route} reader did not read onto the card")
        for name in ("row", "col", "vals"):
            check_equal(f"path E {lines} lines: {route} vs numpy reader, {name}", getattr(c, name),
                        getattr(routes["numpy"], name))
    small = routes["numpy"].convert(CSR)
    check_equal("path E ReorderBase.reorder('degree') vs DegreeReorder on the card",
                ReorderBase.reorder("degree", small), DegreeReorder().get_reorder(small))
    host = small.to_host()
    check_equal("path E ReorderBase.reorder('rcm') on the host (graphkit) vs _rcm_host",
                ReorderBase.reorder("rcm", host), _rcm_host(_symmetrized_square(host)))
    print(f"  path E: {lines} lines read three ways agree; sizes: MTX {os.path.getsize(e.mtx)} bytes, "
          f"SBFF {os.path.getsize(e.sbff)} bytes")


def path_e(g, dev, nnz: int):
    """Path E's phases 3 and 4, after path D. Returns its launch counts."""
    import tempfile

    from sparsebase_tpu_torch import _build

    with tempfile.TemporaryDirectory(prefix="chip_smoke_path_e_") as workdir:
        e = PathE(g, dev, nnz, workdir)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        coo, pipe, donated, back = e.run()
        launches = read_launches("E", ("indptr", "radix_rank", "relocate_csr", "csr_spmv"))
        phase_path_e_checks(e, coo, pipe, donated, back)
    return launches


FEATURE_AVG_DEGREE = 16
FEATURE_LOOPS = 4_096
POWER_LAW_CARD = (1_000_000, 16_000_000)  # rows, entries before mirroring: phase_long_rows's graph
POWER_LAW_HOST = (100_000, 800_000)  # the same generator cut to a size graphkit takes in seconds
COLUMN_STATS = ("MedianDegreeColumn", "StandardDeviationDegreeColumn", "CoefficientOfVariationDegreeColumn",
                "GeometricAvgDegreeColumn")


def random_pairs(g, dev, n, pairs, mirror=True):
    """``pairs`` uniform (u, v) with u != v, mirrored (``2 * pairs``
    entries) or not."""
    u = torch.randint(0, n, (pairs,), generator=g, device=dev)
    v = (u + torch.randint(1, n, (pairs,), generator=g, device=dev)) % n
    if not mirror:
        return u.to(torch.int32), v.to(torch.int32)
    return torch.cat([u, v]).to(torch.int32), torch.cat([v, u]).to(torch.int32)


def with_loops(g, dev, n, row, col, loops):
    """The pattern (row, col) with ``loops`` random self-loops added, as a
    CSR on the card (``COO.new``, K5; ``convert(CSR)``, K3)."""
    from sparsebase_tpu_torch import COO, CSR

    at = torch.randint(0, n, (loops,), generator=g, device=dev, dtype=torch.int32)
    return COO.new(torch.cat([row, at]), torch.cat([col, at]), None, (n, n)).convert(CSR)


def feature_graph(g, dev, n):
    """Path F's graph: ``n * 8`` uniform pairs with u != v, mirrored (average
    degree 16), the first sixteenth of those entries again, and 4,096
    self-loops, row-major sorted by ``COO.new`` (K5)."""
    from sparsebase_tpu_torch import COO

    row, col = random_pairs(g, dev, n, n * FEATURE_AVG_DEGREE // 2)
    k = row.numel() // 16
    loops = torch.randint(0, n, (FEATURE_LOOPS,), generator=g, device=dev, dtype=torch.int32)
    row, col = torch.cat([row, row[:k], loops]), torch.cat([col, col[:k], loops])
    return COO.new(row, col, None, (n, n))


def power_law_pattern(g, dev, n, nnz, mirror=True):
    """``phase_long_rows``'s graph as a pattern CSR on the card: mirrored,
    or as it is with ``FEATURE_LOOPS`` self-loops added."""
    csr = power_law_csr(g, dev, n, nnz)
    rows, cols = csr.row_of_nnz(), csr.indices
    if mirror:
        return with_loops(g, dev, n, torch.cat([rows, cols]), torch.cat([cols, rows]), 0)
    return with_loops(g, dev, n, rows, cols, FEATURE_LOOPS)


class PathF:
    """Path F: ``convert(CSR)`` of a random graph of ``--feature-n`` vertices,
    then every reference feature in one ``GraphFeatureBase.extract`` call.
    The graphs of its checks and times are made here too, before the main
    path runs, so that neither phase depends on the other."""

    DENSE_N = 16_384  # vertices of the graphs on which the dense tier meets K6
    FILL_N = 131_072  # rows of the band whose fill is checked

    def __init__(self, g, dev, n):
        from sparsebase_tpu_torch.ops import feature

        self.g, self.dev, self.n = g, dev, n
        self.coo = feature_graph(g, dev, n)
        # a fused class is no feature of its own (the extractor matches
        # sub-features, in both packages): the 17 others, which the extractor
        # fuses back into DegreesDegreeDistribution and MinMaxAvgDegree
        self.features = [c for c in feature.REFERENCE_FEATURES if not issubclass(c, feature.FusedFeature)]
        # POWER_LAW_CARD's and POWER_LAW_HOST's graphs: mirrored, and as they
        # are with self-loops (directed mode)
        self.power_law = [power_law_pattern(g, dev, *size) for size in (POWER_LAW_CARD, POWER_LAW_HOST)]
        self.power_law_directed = [power_law_pattern(g, dev, *size, mirror=False)
                                   for size in (POWER_LAW_CARD, POWER_LAW_HOST)]
        # at the dense wall, with self-loops: a symmetric graph and a directed one
        dn = self.DENSE_N
        self.dense_sym = with_loops(g, dev, dn, *random_pairs(g, dev, dn, dn * 8), 1_000)
        self.dense_directed = with_loops(g, dev, dn, *random_pairs(g, dev, dn, dn * 16, mirror=False), 1_000)

    def run(self):
        from sparsebase_tpu_torch import CSR, GraphFeatureBase

        csr = self.coo.convert(CSR)
        return csr, GraphFeatureBase.extract(self.features, csr)


def phase_path_f_checks(f: PathF, csr, out) -> float:
    """K6 against its plain version at full size in its three modes; every
    other feature against the same feature on a CPU copy; K6 on the power-law
    graphs against its plain version and, cut to a size the host takes in
    seconds, against graphkit and the torch host helpers; the triangle tiers
    at 16,384 vertices and on K_512; FillIn on a band. Returns K6's largest
    difference from its plain version."""
    from sparsebase_tpu_torch import CSC, CSR, DenseArray, GraphFeatureBase, native
    from sparsebase_tpu_torch.ops import feature
    from sparsebase_tpu_torch.ops.feature.sparse_common import directed_triangle_count_sparse_device
    from sparsebase_tpu_torch.ops.feature.triangles import _device_dense_count, _directed_count
    from sparsebase_tpu_torch.ops.kernels import common_neighbors, common_neighbors_plain

    n, nnz = csr.nrows, csr.nnz
    print(f"phase 4 path F checks: n={n} entries={nnz} (mirrored pairs, a sixteenth again, {FEATURE_LOOPS} self-loops)")
    weights = out[feature.JaccardWeights].vals
    plain = common_neighbors_plain(csr, "jaccard")
    check_equal("path F K6 Jaccard weights vs plain", weights, plain)
    err = float((weights - plain).abs().max()) if nnz else 0.0
    del plain
    tri_sum, tri_plain = common_neighbors(csr, "triangles"), common_neighbors_plain(csr, "triangles")
    check_equal("path F K6 triangle sum vs plain", tri_sum, tri_plain)
    check(out[feature.TriangleCount] == int(tri_plain) // 6, "path F TriangleCount is not the K6 sum / 6")
    csc = csr.convert(CSC)
    check_equal("path F K6 directed sum vs plain", common_neighbors(csr, "directed", csc),
                common_neighbors_plain(csr, "directed", csc))
    directed = feature.TriangleCount(True).get_triangle_count(csr)
    check(directed == 2 * out[feature.TriangleCount], "path F directed TriangleCount (K6) is not twice the undirected "
          "count of the symmetric graph")
    print(f"  path F triangles {out[feature.TriangleCount]} (K6 sum {int(tri_sum)}), directed 3-cycles {directed}")
    # every other feature on a CPU copy; the column features on the card's
    # CSC copied over, whose indptr is first held to the host's column counts
    host = csr.to_host()
    csc_host = csc.to_host()
    del csc
    want_ip = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(torch.bincount(
        host.indices.to(torch.int64), minlength=n), 0)])
    check_equal("path F CSC indptr (K5, K3) vs the host's column counts", csc_host.indptr, want_ip)
    for cls in f.features:
        if cls in (feature.JaccardWeights, feature.TriangleCount):
            continue
        column = "Column" in cls.__name__
        want = GraphFeatureBase.extract([cls], csc_host if column else host)[cls]
        got = out[cls]
        got = got.vals if isinstance(got, DenseArray) else got
        if isinstance(got, torch.Tensor):
            check(got.device == csr.indptr.device, f"path F {cls.__name__} is not on the card")
            got = got.cpu()
        if cls.__name__ in COLUMN_STATS:
            rel = abs(float(got) - float(want)) / max(abs(float(want)), 1e-300)
            check(rel <= 1e-12, f"path F {cls.__name__}: {float(got)!r} vs {float(want)!r} on the CPU")
        elif isinstance(got, torch.Tensor):
            check_equal(f"path F {cls.__name__} vs the CPU", got, want)
        else:
            check(got == want, f"path F {cls.__name__}: {got!r} vs {want!r} on the CPU")
    print(f"  path F: {len(f.features) - 2} other features equal the CPU's (column statistics within 1e-12)")
    del host, csc_host
    # power-law graphs: K6 against its plain version at full size, and
    # against graphkit and the torch host helpers at the cut size
    for pl, pd, size in zip(f.power_law, f.power_law_directed, (POWER_LAW_CARD, POWER_LAW_HOST)):
        deg = pl.degrees()
        label = (f"power-law n={size[0]} entries={pl.nnz} (largest row {int(deg.max())}, {int((deg > 4096).sum())} "
                 "rows over 4,096)")
        jac = common_neighbors(pl, "jaccard")
        check_equal(f"path F K6 Jaccard on {label} vs plain", jac, common_neighbors_plain(pl, "jaccard"))
        tri = common_neighbors(pl, "triangles")
        check_equal(f"path F K6 triangle sum on {label} vs plain", tri, common_neighbors_plain(pl, "triangles"))
        pd_csc = pd.convert(CSC)
        cyc = common_neighbors(pd, "directed", pd_csc)
        check_equal(f"path F K6 directed sum on the same unmirrored, {pd.nnz} entries with self-loops, vs plain", cyc,
                    common_neighbors_plain(pd, "directed", pd_csc))
        if size == POWER_LAW_HOST:
            h, hd = pl.to_host(), pd.to_host()
            check_equal(f"path F K6 Jaccard on {label} vs graphkit", jac.cpu(),
                        native.jaccard(h.nrows, h.indptr, h.indices, h.nnz))
            check(int(tri) // 6 == native.triangles(h.nrows, h.indptr, h.indices, False),
                  f"path F K6 triangles on {label} differ from graphkit's")
            on_host = feature.TriangleCount(True).get_triangle_count(hd)  # graphkit, self-loops dropped
            check(int(cyc) == on_host == _directed_count(hd) > 0,
                  f"path F K6 directed on the unmirrored {label}: {int(cyc)}, graphkit {on_host}")
            print(f"  path F K6 on {label}: {int(tri) // 6} triangles, unmirrored {int(cyc)} directed 3-cycles "
                  "(= graphkit = _directed_count)")
    # the triangle tiers at the dense wall, on graphs with self-loops, and on K_512
    ds, dd = f.dense_sym, f.dense_directed
    hs, hdd = ds.to_host(), dd.to_host()
    und = _device_dense_count(ds, False)
    check(und == common_neighbors(ds, "triangles").item() // 6 == native.triangles(hs.nrows, hs.indptr, hs.indices,
                                                                                 False) > 0,
          "path F at 16,384 vertices: the dense tier, K6 and graphkit differ (undirected)")
    dn = PathF.DENSE_N
    counts = []
    for graph, h in ((ds, hs), (dd, hdd)):
        past = CSR(torch.cat([graph.indptr, graph.indptr[-1:]]), graph.indices, None, (dn + 1, dn + 1))
        tiers = [_device_dense_count(graph, True), feature.TriangleCount(True).get_triangle_count(graph),
                 directed_triangle_count_sparse_device(graph), feature.TriangleCount(True).get_triangle_count(past),
                 feature.TriangleCount(True).get_triangle_count(h), _directed_count(h)]
        check(len(set(tiers)) == 1 and tiers[0] > 0, f"path F at {dn} vertices: directed tiers differ: {tiers} (dense, "
              f"route at {dn}, K6, route at {dn + 1}, graphkit, torch host)")
        counts.append(tiers[0])
    check(counts[0] == 2 * und, "path F at 16,384 vertices: directed count of the symmetric graph is not twice "
          "the undirected")
    m = 512
    i = torch.arange(m, device=f.dev, dtype=torch.int32)
    keep = i.repeat_interleave(m) != i.repeat(m)
    k512 = with_loops(f.g, f.dev, m, i.repeat_interleave(m)[keep], i.repeat(m)[keep], 0)
    want = m * (m - 1) * (m - 2) // 6
    check(_device_dense_count(k512, False) == want == feature.TriangleCount().get_triangle_count(k512),
          "path F K_512: a tier missed C(512, 3)")
    check(_device_dense_count(k512, True) == 2 * want == directed_triangle_count_sparse_device(k512),
          "path F K_512: a directed tier missed 2 C(512, 3)")
    print(f"  path F triangle tiers at {dn} vertices with self-loops: symmetric {und} undirected, {counts[0]} directed; "
          f"directed graph {counts[1]} (dense tier = K6 = the route past the wall = graphkit = torch host); K_512 "
          f"{want} on both tiers, {2 * want} directed")
    band = banded_coo(f.g, f.dev, PathF.FILL_N * (2 * BAND_HALF_WIDTH + 1)).convert(CSR)
    fill = GraphFeatureBase.get_fill_in(band)
    want = sum(min(i, BAND_HALF_WIDTH) + 1 for i in range(band.nrows))
    check(fill == want, f"path F FillIn of the band: {fill}, expected {want}")
    print(f"  path F FillIn of a 33-diagonal band at {band.nrows} rows: {fill} (closed form)")
    return err


def common_neighbors_bytes(n: int, nnz: int, mode: str = "jaccard") -> int:
    """Bytes K6's function must move on a CSR of ``n`` rows and ``nnz``
    entries: its indptr (int64) and ids (int32) read once, the CSC's too in
    directed mode, and the float32 weights (jaccard) or one int64 sum
    (triangles, directed) written once. Its compares are integer
    operations: the bytes bound it."""
    lists = 8 * (n + 1) + 4 * nnz
    return (2 * lists if mode == "directed" else lists) + (4 * nnz if mode == "jaccard" else 8)


def streamed_bytes(csr, mode: str) -> int:
    """What K6's stream direction reads on a CSR in a mode: the N(v) (4
    bytes an id) and indptr pair (16 bytes) of every entry (u, v) the mode
    counts (jaccard: all; triangles: u != v; directed: v > u; the last two
    skip an entry that repeats the one before it); a diagnostic beside the
    bound, which counts each input once."""
    deg = csr.degrees().to(torch.int64)
    u, v = csr.row_of_nnz().long(), csr.indices.long()
    counted = torch.ones_like(v, dtype=torch.bool)
    if mode != "jaccard":
        pos = torch.arange(v.numel(), device=v.device)
        repeat = (pos > csr.indptr[u]) & (v == v[(pos - 1).clamp(min=0)])
        counted = ~repeat & ((u != v) if mode == "triangles" else (v > u))
    return int(((4 * deg[v] + 16) * counted).sum())


def path_f(g, dev, n: int):
    """Path F's phases 3 and 4, after path E. Returns its launch counts,
    K6's largest difference from its plain version and its graph's CSR
    (the kernel table's K6 input)."""
    from sparsebase_tpu_torch import _build

    f = PathF(g, dev, n)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    csr, out = f.run()
    launches = read_launches("F", ("indptr", "radix_rank", "common_neighbors"))
    err = phase_path_f_checks(f, csr, out)
    return launches, err, csr


HOST_REORDER_GRAPH = (32_768, 262_144)  # vertices, entries before mirroring: the host reorderers' power-law graph
HOST_REORDERERS = (("slashburn", {"k_size": 8}), ("amd", None), ("metis", None), ("rabbit", None))
HEATMAP_PARTS = 8


class PathG:
    """Path G: the reorderers. The device part takes path A's COO: its
    ``convert(CSR)`` (K3), ``GrayReorder`` on the CSR and ``BOBAReorder`` on
    the COO (both K5), ``DegreeReorder`` (K5), and one
    ``ReorderHeatmap(8).get_heatmap_with_stats`` under each of the natural,
    degree, Gray and BOBA orders. The host part takes a power-law graph of
    32,768 vertices on the card through ``ReorderBase.reorder`` by name:
    SlashBurn (k = 8), AMD, nested dissection ("metis") and Rabbit."""

    def __init__(self, g, dev, coo):
        self.coo = coo
        self.host_graph = power_law_pattern(g, dev, *HOST_REORDER_GRAPH)

    def run(self):
        from sparsebase_tpu_torch import CSR, DenseArray, ReorderBase
        from sparsebase_tpu_torch.ops.reorder import BOBAReorder, DegreeReorder, GrayReorder, ReorderHeatmap

        csr = self.coo.convert(CSR)
        orders = {"natural": torch.arange(csr.nrows, dtype=torch.int32, device=csr.indptr.device),
                  "degree": DegreeReorder().get_reorder(csr), "gray": GrayReorder().get_reorder(csr),
                  "boba": BOBAReorder().get_reorder(self.coo)}
        heat = {label: ReorderHeatmap(HEATMAP_PARTS).get_heatmap_with_stats(csr, DenseArray(o), DenseArray(o))
                for label, o in orders.items()}
        host = [ReorderBase.reorder(name, self.host_graph, params=params) for name, params in HOST_REORDERERS]
        return csr, orders, heat, host


def check_heatmap(label: str, csr, order, heat, stats) -> None:
    """The grid sums to 1 within 1e-5 and the stats equal a recount by plain
    torch ops on the card."""
    b = HEATMAP_PARTS
    total = float(heat.vals.to(torch.float64).sum())
    check(heat.vals.device == csr.indptr.device and heat.vals.shape == (b * b,), f"path G heatmap {label}: placement")
    check(abs(total - 1.0) <= 1e-5, f"path G heatmap {label}: the grid sums to {total!r}")
    u = order.long()[csr.row_of_nnz().long()]
    v = order.long()[csr.indices.long()]
    bw = (u - v).abs()
    bsize = csr.nrows // b
    blocks = torch.zeros((b, b), dtype=torch.int64, device=u.device)
    blocks.index_put_((torch.clamp(u // bsize, max=b - 1), torch.clamp(v // bsize, max=b - 1)),
                      torch.ones_like(u), accumulate=True)
    i = torch.arange(b, device=u.device)
    want = {"mean_bw": int(bw.sum()) / csr.nnz, "max_bw": int(bw.max()), "num_full_blocks": int((blocks > 0).sum()),
            "block_mean_bw": int(((i[:, None] - i[None, :]).abs() * blocks).sum()) / csr.nnz}
    check(stats == want, f"path G heatmap {label}: stats {stats} against a recount {want}")


def phase_path_g_checks(p: PathG, csr, orders, heat, host) -> None:
    """Every path G result against the port's CPU route of the same function
    on host copies of the full graph; the heatmaps against a recount; Gray
    and BOBA with no host sync (nothing leaves the card)."""
    from sparsebase_tpu_torch import DenseArray, ReorderBase
    from sparsebase_tpu_torch.ops.reorder import BOBAReorder, GrayReorder, ReorderHeatmap

    n = csr.nrows
    print(f"phase 4 path G checks: n={n} entries={csr.nnz}, the CPU routes on host copies of the full graph")
    host_csr, host_coo = csr.to_host(), p.coo.to_host()
    for label, order in orders.items():
        check(order.device == csr.indptr.device and order.dtype == torch.int32, f"path G {label} order placement")
        check(bool((torch.bincount(order.long(), minlength=n) == 1).all()), f"path G {label} order: no permutation")
    for label, fn in (("gray", lambda: GrayReorder().get_reorder(host_csr)),
                      ("boba", lambda: BOBAReorder().get_reorder(host_coo))):
        check_equal(f"path G {label} order, card vs the CPU route", orders[label].cpu(), fn())
    for label, order in orders.items():
        grid, stats = heat[label]
        check_heatmap(label, csr, order, grid, stats)
        cpu_grid, cpu_stats = ReorderHeatmap(HEATMAP_PARTS).get_heatmap_with_stats(
            host_csr, DenseArray(order.cpu()), DenseArray(order.cpu()))
        check_equal(f"path G heatmap grid ({label}), card vs the CPU route", grid.vals.cpu(), cpu_grid.vals)
        check(stats == cpu_stats, f"path G heatmap stats ({label}): card {stats}, CPU {cpu_stats}")
        print(f"  path G heatmap stats under the {label} order: mean_bw {stats['mean_bw']!r}, max_bw "
              f"{stats['max_bw']}, num_full_blocks {stats['num_full_blocks']} of {HEATMAP_PARTS ** 2}, "
              f"block_mean_bw {stats['block_mean_bw']!r}")
    for label, op, fmt in (("GrayReorder", GrayReorder(), csr), ("BOBAReorder", BOBAReorder(), p.coo)):
        syncs = count_host_syncs(lambda: op.get_reorder(fmt))
        check(syncs == 0, f"path G {label} synced the host {syncs} times: something left the card")
    # the heatmap's three: torch.bincount's reads of its range, the stats' one read
    gray = DenseArray(orders["gray"])
    syncs = count_host_syncs(lambda: ReorderHeatmap(HEATMAP_PARTS).get_heatmap_with_stats(csr, gray, gray))
    check(syncs <= 3, f"path G heatmap synced the host {syncs} times, more than bincount's and the stats' reads")
    graph = p.host_graph
    host_graph = graph.to_host()
    for (name, params), order in zip(HOST_REORDERERS, host):
        check(order.device == graph.indptr.device and order.dtype == torch.int32,
              f"path G {name}: the order is not int32 on the card")
        check(bool((torch.bincount(order.long(), minlength=graph.nrows) == 1).all()), f"path G {name}: no permutation")
        check_equal(f"path G {name} on the card vs on a CPU copy", order.cpu(),
                    ReorderBase.reorder(name, host_graph, params=params))
    print(f"  path G host reorderers on n={graph.nrows}, {graph.nnz} entries: each order int32 on the card and equal "
          f"to the call on a CPU copy")


def path_g(g, dev, coo):
    """Path G's phases 3 and 4, after path F, on path A's COO. Returns its
    launch counts and its host reorderers' graph."""
    from sparsebase_tpu_torch import _build

    p = PathG(g, dev, coo)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    csr, orders, heat, host = p.run()
    launches = read_launches("G", ("indptr", "radix_rank"))
    phase_path_g_checks(p, csr, orders, heat, host)
    return launches, p.host_graph


PARTITION_K = 8
PARTITION_ROUNDS = 10
K7_EDGE_CASES = (  # (label, rows, average degree, k, options)
    ("k = 2", 1_000_000, 16, 2, {}),
    ("k = 8", 1_000_000, 16, 8, {}),
    ("k = 64", 200_000, 12, 64, {}),
    ("k = 4096", 20_000, 40, 4_096, {}),
    ("k = 8192, past the shared-memory tier", 5_000, 30, 8_192, {}),
    ("a row of 262144 entries", 100_000, 16, 8, dict(long_row=True)),
    ("every third row empty", 300_000, 16, 8, dict(empty_every=3)),
    ("no entries", 1_000, 0, 8, {}),
    ("integer-valued weights", 500_000, 16, 8, dict(weights="integer")),
    ("integer-valued weights, k = 8192", 3_000, 30, 8_192, dict(weights="integer")),
    ("real weights", 500_000, 16, 8, dict(weights="real")),
    ("real weights, k = 200", 100_000, 16, 200, dict(weights="real")),
    ("ids off 16-byte alignment", 300_000, 16, 8, dict(misaligned=True)),
)
K7_TIER_CASES = (  # the same, drawn from a generator of their own (k7_cases)
    ("n * k = nnz (cells stored)", 500_000, 8, 8, dict(exact=True)),
    ("n * k = nnz + n (two passes)", 500_000, 8, 9, dict(exact=True)),
    ("k = 8, the last register tier, two passes", 300_000, 7, 8, dict(exact=True)),
    ("k = 9, the first shared tier, stored", 300_000, 9, 9, dict(exact=True)),
    ("k = 16, shared tier, stored", 300_000, 16, 16, dict(exact=True)),
    ("every vertex in one part, k = 8", 1_000_000, 16, 8, dict(one_part=True)),
    ("every vertex in one part, k = 64", 100_000, 64, 64, dict(one_part=True)),
    ("real weights, stored, k = 12", 500_000, 16, 12, dict(weights="real")),
    ("k = 255, the last 1-byte gather, stored", 20_000, 300, 255, dict(exact=True)),
    ("k = 256, stored", 20_000, 300, 256, dict(exact=True)),
    ("labels outside [0, k)", 300_000, 16, 8, dict(outside=True)),
    ("a power-law tail of rows past SPLIT_ROWS (the span pass)", 1_000_000, 16, 8, dict(tail=(2_000, 600_000))),
)


def k7_case(g, dev, n, avg_deg, k, long_row=False, empty_every=0, misaligned=False, weights=None, exact=False,
            one_part=False, outside=False, tail=None):
    """A CSR of ``n`` rows (degrees uniform in [0, 2 * avg_deg], or all
    ``avg_deg`` with ``exact``; ids uniform in [0, n)), with ``tail =
    (count, top)`` ``count`` rows spread evenly whose lengths fall as ``top
    / i^0.8``, and labels in [0, k) with half the vertices in part 0, so
    that the penalty bites, or all in part k - 1 with ``one_part``, some
    outside [0, k) with ``outside``; weights None, "integer" (1..5) or
    "real". K7 keeps the cells between its launches where n * k <= nnz,
    counts in registers up to k = 8 (there, unweighted, rows over
    SPLIT_ROWS go to its span pass) and gathers 1-byte labels up to k =
    255."""
    from sparsebase_tpu_torch import CSR
    from sparsebase_tpu_torch.convert.kernels import indptr_from_counts

    deg = torch.randint(0, 2 * avg_deg + 1, (n,), generator=g, device=dev)
    if exact:
        deg.fill_(avg_deg)
    if empty_every:
        deg[::empty_every] = 0
    if long_row:
        deg[n // 3] = 262_144
    if tail is not None:
        count, top = tail
        rows = torch.linspace(0, n - 1, count, device=dev).long()
        deg[rows] = (top / torch.arange(1, count + 1, device=dev, dtype=torch.float64) ** 0.8).long()
    indptr = indptr_from_counts(deg)
    nnz = int(indptr[-1])
    ids = torch.randint(0, n, (nnz,), generator=g, device=dev, dtype=torch.int32)
    if misaligned:
        buf = torch.empty((nnz + 1,), dtype=torch.int32, device=dev)
        buf[1:] = ids
        ids = buf[1:]
    w = None
    if weights == "integer":
        w = torch.randint(1, 6, (nnz,), generator=g, device=dev).to(torch.float32)
    elif weights == "real":
        w = torch.rand((nnz,), generator=g, device=dev) * 3
    labels = torch.randint(0, k, (n,), generator=g, device=dev, dtype=torch.int32)
    labels[: n // 2] = 0
    if one_part:
        labels.fill_(k - 1)
    if outside:
        labels[::5] = k + 300
        labels[1::7] = -3
    return CSR(indptr, ids, w, (n, n)), labels


def check_k7(label: str, csr, labels, k, alpha, cap) -> None:
    """K7 against its plain version: equal where the counts are integers;
    with real weights a row may differ only where its two best scores lie
    within 8 ulp (the plain version's card sums take another order)."""
    from sparsebase_tpu_torch.ops.kernels import label_prop_round, label_prop_round_plain
    from sparsebase_tpu_torch.ops.kernels.label_prop import neighbor_counts, part_counts, penalty_plain

    got = label_prop_round(csr, labels, k, alpha, cap, csr.vals)
    again = label_prop_round(csr, labels, k, alpha, cap, csr.vals)
    want = label_prop_round_plain(csr, labels, k, alpha, cap, csr.vals)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"K7 {label}: two runs differ")
    diff = torch.nonzero(got != want).flatten()
    real = csr.vals is not None and not bool((csr.vals == csr.vals.round()).all())
    near = 0
    if diff.numel() and real:
        counts = neighbor_counts(csr, labels, k, csr.vals)
        scores = (counts - penalty_plain(counts, part_counts(labels, k), alpha, cap)[None, :])[diff]
        a = scores.gather(1, got[diff].long()[:, None]).flatten()
        b = scores.gather(1, want[diff].long()[:, None]).flatten()
        near = int(((a - b).abs() <= 8 * EPS_F32 * torch.maximum(a.abs(), b.abs())).sum())
    print(f"  K7 {label}: n={csr.nrows} entries={csr.nnz} k={k} alpha={alpha} rows differing {diff.numel()}"
          + (f" (all within 8 ulp of a tie: {near == diff.numel()})" if real else ""))
    check(diff.numel() == near, f"K7 {label}: {diff.numel() - near} rows differ from the plain version")


def k7_cases(g, dev, seed: int):
    """Phase 2's K7 inputs, ``(label, csr, labels, k)``: K7_EDGE_CASES drawn
    from ``g``, then K7_TIER_CASES from a generator of their own seeded with
    ``seed``, so that a case added there leaves the draws of every graph
    made from ``g`` after phase 2 as they were."""
    own = torch.Generator(device=dev)
    own.manual_seed(seed)
    for cases, gen in ((K7_EDGE_CASES, g), (K7_TIER_CASES, own)):
        for label, n, avg_deg, k, opts in cases:
            yield (label, *k7_case(gen, dev, n, avg_deg, k, **opts), k)


def phase_k7_vs_plain(g, dev, seed: int) -> None:
    print("phase 2 K7 (label propagation round) vs plain")
    for label, csr, labels, k in k7_cases(g, dev, seed):
        for alpha in (0.1, 1.0):
            check_k7(label, csr, labels, k, alpha, 1.1 * csr.nrows / k)


PARTITIONERS = (  # (label, class name, parameters, use_graphkit)
    ("PulpPartition (graphkit)", "PulpPartition", {}, True),
    ("PulpPartition (use_graphkit off: K7)", "PulpPartition", {}, False),
    ("MetisPartition kway (graphkit)", "MetisPartition", {}, True),
    ("MetisPartition rb", "MetisPartition", {"ptype": "rb"}, True),
    ("PatohPartition", "PatohPartition", {}, True),
)


PLANTED_INSIDE = 0.95  # the planted graph: share of a row's entries inside its block


def planted_coo(g, dev, n, nnz, k=PARTITION_K, inside=PLANTED_INSIDE):
    """A graph with ``k`` planted parts: path A's rows (uniform, so its
    degrees) over ``k`` blocks of ``n / k`` vertices; an entry's column lies
    in its row's block with probability ``inside``, else in one of the
    other ``k - 1`` blocks, uniform within the block. The vertex ids are then
    shuffled by a permutation drawn from ``g``, so that the contiguous chunks
    ``partition_pipeline`` starts from hold no part of the answer. Row-major
    sorted, duplicates kept. Returns the COO and the planted labels (int32,
    by shuffled id)."""
    from sparsebase_tpu_torch import COO
    from sparsebase_tpu_torch.convert.kernels import sort_by_pairs_plain

    if k < 2 or n % k:
        raise ValueError(f"planted_coo: {n} vertices do not split into {k} equal blocks")
    size = n // k
    row = torch.randint(0, n, (nnz,), generator=g, device=dev)
    block = row // size
    other = (block + torch.randint(1, k, (nnz,), generator=g, device=dev)) % k
    block = torch.where(torch.rand((nnz,), generator=g, device=dev) < inside, block, other)
    del other
    col = block * size + torch.randint(0, size, (nnz,), generator=g, device=dev)
    del block
    perm = torch.randperm(n, generator=g, device=dev).to(torch.int32)
    row, col = perm[row], perm[col]
    planted = torch.empty((n,), dtype=torch.int32, device=dev)
    planted[perm.long()] = (torch.arange(n, device=dev) // size).to(torch.int32)
    vals = torch.randn((nnz,), generator=g, device=dev)
    row, col, vals = sort_by_pairs_plain(row, col, vals)
    return COO(row, col, vals, (n, n)), planted


class PathH:
    """Path H: partitioning. ``partition_pipeline`` on path A's COO (K3, K7
    ten times, K5, K4, K2) and on the planted graph of the same size, then
    each partitioner by name on path G's power-law graph of 32,768 vertices
    on the card."""

    def __init__(self, coo, x, graph, planted):
        self.coo, self.x, self.graph = coo, x, graph
        self.planted_coo, self.planted_x, self.planted = planted

    def graphs(self):
        """``(label, coo, x, planted labels or None)`` of the pipeline's two graphs."""
        return (("path A's graph", self.coo, self.x, None),
                ("the planted graph", self.planted_coo, self.planted_x, self.planted))

    def partitioners(self):
        """``{label: (labels, K7 launches)}``, one call each."""
        from sparsebase_tpu_torch import _build, get_config, set_config
        from sparsebase_tpu_torch.ops import partition

        out = {}
        saved = get_config().use_graphkit
        try:
            for label, cls, params, graphkit in PARTITIONERS:
                set_config(use_graphkit=graphkit)
                before = _build.launch_counts()["label_prop"]
                labels = getattr(partition, cls)(num_partitions=PARTITION_K, **params).partition(self.graph)
                out[label] = (labels, _build.launch_counts()["label_prop"] - before)
        finally:
            set_config(use_graphkit=saved)
        return out


def pipeline_h(coo, x):
    from sparsebase_tpu_torch.models import partition_pipeline

    return partition_pipeline(coo, x, PARTITION_K, PARTITION_ROUNDS)


def phase_path_h_pipeline_checks(label, coo, x, permuted, y, labels, planted) -> float:
    """One graph's pipeline: its labels against ``_propagate`` through the
    plain round on the card, its permuted CSR against the plain relocation,
    ``y`` against the plain SpMV; the labels a partition; ten rounds with no
    host sync; the part sizes, balance and edge cut (against the planted
    cut where there is one). Returns K7's largest difference from its plain
    version."""
    from sparsebase_tpu_torch import CSR
    from sparsebase_tpu_torch.ops import partition
    from sparsebase_tpu_torch.ops.kernels import (
        csr_spmv_plain, indptr_plain, label_prop_round_plain, radix_rank_plain, relocate_csr_plain,
    )
    from sparsebase_tpu_torch.ops.partition.labelprop import _chunks, _propagate

    k, n = PARTITION_K, coo.nrows
    print(f"phase 4 path H checks, {label}: n={n} entries={coo.nnz} k={k} rounds={PARTITION_ROUNDS}")
    src = CSR(indptr_plain(coo.row, n), coo.col, coo.vals, coo.shape)
    cap = 1.1 * n / k
    want = _chunks(n, k, src.indptr.device)
    for it in range(PARTITION_ROUNDS):
        want = label_prop_round_plain(src, want, k, (it + 1) / PARTITION_ROUNDS, cap)
    check(labels.device == src.indptr.device and labels.dtype == torch.int32 and labels.shape == (n,),
          f"path H {label} labels: not int32 on the card")
    check(bool(((labels >= 0) & (labels < k)).all()), f"path H {label} labels: outside [0, k)")
    check_equal(f"path H {label} labels vs _propagate through the plain round", labels, want)
    err = float((labels - want).abs().max())
    ro = radix_rank_plain(labels.long())
    check_csr_equal(f"path H {label} permuted CSR vs plain relocation", permuted, relocate_csr_plain(src, ro, ro))
    x_new = torch.empty_like(x)
    x_new[ro] = x
    check_rows(f"path H {label} y vs plain SpMV of the permuted matrix", y, csr_spmv_plain(permuted, x_new),
               permuted.degrees(), csr_spmv_plain(abs_csr(permuted), x_new.abs()))
    labels0 = _chunks(n, k, src.indptr.device)
    syncs = count_host_syncs(lambda: _propagate(src, labels0, k, cap, None, PARTITION_ROUNDS, stop_when_stable=False))
    print(f"  path H {label}: {PARTITION_ROUNDS} rounds of _propagate on the card synced the host {syncs} times")
    check(syncs == 0, f"path H {label}: _propagate synced the host {syncs} times")
    pipe_syncs = count_host_syncs(lambda: pipeline_h(coo, x))
    print(f"  path H {label} partition_pipeline: host syncs in one call {pipe_syncs} (K4's count of its long rows)")
    sizes = partition.part_sizes(labels, k)
    cuts = f"chunks {partition.edge_cut(src, labels0)}, after propagation {partition.edge_cut(src, labels)}"
    if planted is not None:
        cuts += f", planted {partition.edge_cut(src, planted)}"
        # each part's largest planted block: the vertices the pipeline put with their block
        pair = labels.long() * k + planted.long()
        most = torch.zeros((k * k,), dtype=torch.int64, device=pair.device).index_add_(
            0, pair, torch.ones_like(pair)).view(k, k).amax(dim=1).sum()
        cuts += f"; vertices in their part's largest planted block {int(most)} of {n}"
    print(f"  path H {label} part sizes {sizes.tolist()}, balance {partition.balance_ratio(labels, k):.6f}, edge cut "
          f"(entries across parts / 2): {cuts}")
    return err


def phase_path_h_partitioner_checks(h: PathH, parts) -> None:
    """Each partitioner's labels on path G's graph against the same call on a CPU copy."""
    from sparsebase_tpu_torch import get_config, set_config
    from sparsebase_tpu_torch.ops import partition

    k, graph = PARTITION_K, h.graph
    host_graph = graph.to_host()
    nets, pins, _ = partition.column_net_hypergraph(graph)
    saved = get_config().use_graphkit
    try:
        for (label, cls, params, graphkit), (got, k7) in zip(PARTITIONERS, parts.values()):
            check(got.device == graph.indptr.device and got.dtype == torch.int32, f"path H {label}: placement")
            check(bool(((got >= 0) & (got < k)).all()), f"path H {label}: labels outside [0, k)")
            set_config(use_graphkit=graphkit)
            cpu = getattr(partition, cls)(num_partitions=k, **params).partition(host_graph)
            check_equal(f"path H {label} on the card vs on a CPU copy", got.cpu(), cpu)
            check((k7 > 0) == (not graphkit and cls == "PulpPartition"), f"path H {label}: K7 launched {k7} times")
            print(f"  path H {label} on n={graph.nrows}, {graph.nnz} entries: edge cut {partition.edge_cut(graph, got)}"
                  f", connectivity-1 {partition.cutsize_connectivity(nets, pins, got, k)}, balance "
                  f"{partition.balance_ratio(got, k):.6f}, K7 launches {k7}")
    finally:
        set_config(use_graphkit=saved)


def path_h(coo, x, graph, planted):
    """Path H's phases 3 and 4, after path G, on path A's COO, the planted
    graph ``(coo, x, planted labels)`` and path G's host graph. Returns the
    launch counts of the pipeline on path A's graph and K7's largest
    difference from its plain version."""
    from sparsebase_tpu_torch import _build

    h = PathH(coo, x, graph, planted)
    outs, launches = [], None
    for label, g_coo, g_x, _ in h.graphs():
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        outs.append(pipeline_h(g_coo, g_x))
        counts = read_launches(f"H, {label}", ("indptr", "label_prop", "radix_rank", "relocate_csr", "csr_spmv"))
        check(counts["label_prop"] == PARTITION_ROUNDS, f"path H, {label}: K7 launched {counts['label_prop']} times")
        launches = launches or counts
    parts = h.partitioners()
    err = 0.0
    for (label, g_coo, g_x, g_planted), (g_perm, g_y, g_labels) in zip(h.graphs(), outs):
        err = max(err, phase_path_h_pipeline_checks(label, g_coo, g_x, g_perm, g_y, g_labels, g_planted))
    phase_path_h_partitioner_checks(h, parts)
    return launches, err


EXPERIMENT_REPS = 3
EXPERIMENT_PREPROCESSES = ("pass", "degree", "gray", "boba")  # reorder_csr of DegreeReorder, GrayReorder, BOBAReorder
DASHBOARD_PARTS = 64
DASHBOARD_ORDERINGS = ("degree", "gray", "boba")
SLEEP_MS = 50.0  # the enqueued work that the harness's sync must wait for
K2_KERNELS = ("csr_spmv_tiles", "csr_spmv_fixup")  # csrc/csr_spmv.cu's kernels, as a trace names them
SUITE_MATRIX = "rand-20k"  # the suite's other matrix, mesh-90k, runs apart (the module docstring)


def experiment_spmv(data, fparams, pparams, kparams):
    """The experiment's ``spmv`` kernel: ``spmv(csr, ones)`` (K2)."""
    from sparsebase_tpu_torch import spmv

    return spmv(data, torch.ones((data.ncols,), device=data.indptr.device))


def experiment_jaccard(data, fparams, pparams, kparams):
    """The experiment's ``jaccard`` kernel: ``JaccardWeights`` (K6)."""
    from sparsebase_tpu_torch.ops.feature import JaccardWeights

    return JaccardWeights().get_jaccard_weights(data)


EXPERIMENT_KERNELS = (("spmv", experiment_spmv), ("jaccard", experiment_jaccard))


def reorderer(pid: str):
    from sparsebase_tpu_torch.ops.reorder import BOBAReorder, DegreeReorder, GrayReorder

    return {"degree": DegreeReorder, "gray": GrayReorder, "boba": BOBAReorder}[pid]


def sleep_cycles(ms: float) -> int:
    """Cycles of ``torch.cuda._sleep`` that take about ``ms`` on this card
    (5% over, from one timed call of 10M cycles)."""
    torch.cuda._sleep(1_000_000)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    torch.cuda.synchronize()
    return int(10_000_000 * ms / start.elapsed_time(end) * 1.05)


class PathI:
    """Path I: the harness. A graph made as path E's (path A's generator at
    ``--ingest-nnz`` entries) written as a symmetric MTX file; the reference's
    ``custom_experiment`` on it (``ConcreteExperiment(warmup=1)``, ``load_csr``
    onto the card, ``pass_preprocess`` and ``reorder_csr`` of the degree, Gray
    and BOBA reorderers, the kernels ``spmv`` (K2) and ``jaccard`` (K6),
    three reps); the dashboard of the loaded CSR with the degree, Gray and BOBA
    orderings (counts, then ``|values|``) and the visualizer's CLI on the file
    in a subprocess; the suite's ``run_matrix`` on rand-20k."""

    def __init__(self, g, dev, nnz: int, workdir: str):
        self.dev = dev
        self.n = max(nnz // 16, 1)
        self.src = power_law_coo(g, dev, self.n, nnz)
        self.workdir = workdir
        self.mtx = f"{workdir}/path_i.mtx"
        self.cli_html = f"{workdir}/cli.html"

    def experiment(self, preprocesses, kernels, warmup=1, trace_dir=None, times=EXPERIMENT_REPS, loader=None):
        from sparsebase_tpu_torch.experiment import ConcreteExperiment, load_csr, pass_preprocess, reorder_csr

        e = ConcreteExperiment(warmup=warmup, trace_dir=trace_dir)
        e.add_data_loader(loader or load_csr, [([self.mtx], None)])
        for pid in preprocesses:
            e.add_preprocess(pid, pass_preprocess if pid == "pass" else reorder_csr(reorderer(pid)))
        for kid, fn in kernels:
            e.add_kernel(kid, fn)
        return e.run(times=times, store_auxiliary=True)

    def dashboard(self, csr, weights: bool):
        from sparsebase_tpu_torch.utils.visualizer import _report

        viz = _report(csr, "path_i.mtx", DASHBOARD_ORDERINGS, DASHBOARD_PARTS, plot_edges_by_weights=weights)
        return viz, viz.to_html()

    def run(self):
        from sparsebase_tpu_torch import IOBase, bench_suite

        IOBase.write_coo_to_mtx(self.src, self.mtx, symmetry="symmetric")
        exp = self.experiment(EXPERIMENT_PREPROCESSES, EXPERIMENT_KERNELS)
        csr = exp.get_auxiliary()[f"data,{self.mtx}"]
        dash = {w: self.dashboard(csr, w) for w in (False, True)}
        cmd = [sys.executable, "-m", "sparsebase_tpu_torch.utils.visualizer", self.mtx, self.cli_html,
               "--orderings", ",".join(DASHBOARD_ORDERINGS), "--parts", str(DASHBOARD_PARTS)]
        cli = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=REPO)
        graph = bench_suite.MATRICES[SUITE_MATRIX]("cuda")
        return exp, csr, dash, cli, (graph, bench_suite.run_matrix(SUITE_MATRIX, graph)[SUITE_MATRIX])


def check_experiment_read(i: PathI, csr) -> None:
    """The CSR ``load_csr`` read back: the source's lower triangle mirrored
    by plain torch ops, in canonical order, values exactly."""
    mirrored = mirrored_lower(i.src)
    dev = i.src.row.device
    check(csr.indptr.device == dev and csr.nnz == mirrored[0].numel() and csr.shape == (i.n, i.n),
          f"path I load_csr: {csr.nnz} entries of {csr.shape} on {csr.indptr.device}, expected {mirrored[0].numel()} "
          f"on {dev}")
    check_read_back("path I load_csr", (csr.row_of_nnz(), csr.indices, csr.vals), mirrored)


def phase_path_i_experiment_checks(i: PathI, exp, csr) -> float:
    """The run times' keys in the JAX order; each preprocess's matrix against
    the plain relocation under its order, the order against the CPU route on
    host copies; ``spmv`` per row against the plain SpMV of that matrix;
    ``jaccard`` on ``pass`` equal to K6 called directly and to its plain
    version, on a reordered matrix equal to the source's weights carried
    through the order. Returns K2's largest difference."""
    from sparsebase_tpu_torch import CSR
    from sparsebase_tpu_torch.ops.kernels import common_neighbors, common_neighbors_plain, csr_spmv_plain
    from sparsebase_tpu_torch.ops.kernels import relocate_csr_plain

    print(f"phase 4 path I checks: n={csr.nrows} entries={csr.nnz}")
    keys = [f"{i.mtx},{pid},{kid},{r}" for pid in EXPERIMENT_PREPROCESSES for kid, _ in EXPERIMENT_KERNELS
            for r in range(EXPERIMENT_REPS)]
    check(list(exp.get_run_times()) == keys, f"path I run-time keys {list(exp.get_run_times())[:4]}... not {keys[:4]}...")
    check(list(exp.get_results()) == keys and all(t > 0 for t in exp.get_run_times().values()),
          "path I results' keys or run times")
    print(f"  path I {len(keys)} run times, keys in the JAX order: {keys[0]!r} ... {keys[-1]!r}")
    check_experiment_read(i, csr)
    aux, res = exp.get_auxiliary(), exp.get_results()
    host = csr.to_host()
    w_src = common_neighbors(csr, "jaccard")
    check_equal("path I jaccard K6 vs its plain version", w_src, common_neighbors_plain(csr, "jaccard"))
    ones = torch.ones((csr.ncols,), device=csr.indptr.device)
    err = 0.0
    for pid in EXPERIMENT_PREPROCESSES:
        mat = aux[f"preprocess,{pid},{i.mtx}"]
        if pid == "pass":
            check(mat is csr, "path I pass_preprocess did not return its input")
            want_w = w_src
        else:
            order = reorderer(pid)().get_reorder(csr)
            check_equal(f"path I {pid} order, card vs the CPU route on host copies", order.cpu(),
                        reorderer(pid)().get_reorder(host))
            check_csr_equal(f"path I reorder_csr({pid}) vs the plain relocation", mat,
                            relocate_csr_plain(csr, order, order))
            want_w = relocate_csr_plain(CSR(csr.indptr, csr.indices, w_src, csr.shape), order, order).vals
        y_ref, absdot = csr_spmv_plain(mat, ones), csr_spmv_plain(abs_csr(mat), ones)
        y = res[f"{i.mtx},{pid},spmv,0"]
        err = max(err, check_rows(f"path I {pid} spmv vs the plain SpMV", y, y_ref, mat.degrees(), absdot))
        w = res[f"{i.mtx},{pid},jaccard,0"].vals
        check_equal(f"path I {pid} jaccard vs {'K6 called directly' if pid == 'pass' else 'the weights through the order'}",
                    w, want_w)
        for r in range(1, EXPERIMENT_REPS):  # K2 and K6 give the same bits on every run
            check(torch.equal(res[f"{i.mtx},{pid},spmv,{r}"], y) and torch.equal(res[f"{i.mtx},{pid},jaccard,{r}"].vals, w),
                  f"path I {pid}: rep {r} differs from rep 0")
    return err


def phase_path_i_sync_checks(i: PathI) -> None:
    """On the card: a kernel that enqueues ``SLEEP_MS`` of work and returns a
    CUDA tensor, or ``None``, is recorded at ``SLEEP_MS`` or more; a kernel
    that raises makes ``run()`` raise."""
    from sparsebase_tpu_torch.experiment import ConcreteExperiment, pass_preprocess

    cycles = sleep_cycles(SLEEP_MS)
    dev = i.dev

    def sleeping(returns):
        def kernel(data, fparams, pparams, kparams):
            torch.cuda._sleep(cycles)
            return torch.ones((1,), device=dev) if returns else None
        return kernel

    def failing(data, fparams, pparams, kparams):
        raise RuntimeError("a failing kernel")

    e = ConcreteExperiment(warmup=0)
    e.add_data_loader(lambda files: files, [(["none"], None)])
    e.add_preprocess("pass", pass_preprocess)
    e.add_kernel("tensor", sleeping(True))
    e.add_kernel("none", sleeping(False))
    times = e.run(times=2).get_run_times()
    print(f"  path I sync: torch.cuda._sleep({cycles}) recorded at " + ", ".join(
        f"{k.split(',', 1)[1]} {v * 1e3:.3f} ms" for k, v in times.items()))
    check(all(v * 1e3 >= SLEEP_MS for v in times.values()), f"path I sync: a run recorded under {SLEEP_MS} ms")
    e = ConcreteExperiment(warmup=0)
    e.add_data_loader(lambda files: files, [(["none"], None)])
    e.add_preprocess("pass", pass_preprocess)
    e.add_kernel("fails", failing)
    try:
        e.run()
    except RuntimeError as err:
        check("a failing kernel" in str(err), f"path I: run() raised another error: {err}")
    else:
        raise SmokeFailure("path I: a failing kernel did not make run() raise")
    print("  path I: a kernel that raises makes run() raise")


def phase_path_i_trace(i: PathI, csr) -> None:
    """One traced run on the loaded CSR: one preprocess, one kernel, one rep;
    the Chrome trace names the run's scope, a dispatch span and K2's device
    kernels (``cat == "kernel"``)."""
    import os

    trace_dir = f"{i.workdir}/traces"
    i.experiment(("pass",), EXPERIMENT_KERNELS[:1], warmup=0, trace_dir=trace_dir, times=1, loader=lambda files: csr)
    path = f"{trace_dir}/pass-spmv-0/trace.json"
    check(os.path.exists(path), f"path I: no trace at {path}")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {ev.get("name") for ev in events}
    ops = sorted(n for n in names if str(n).startswith("sbtorch:op:"))
    check("pass-spmv-0" in names and ops, f"path I trace: scope or sbtorch:op: spans missing ({len(names)} names)")
    kernels = sorted({str(ev.get("name"))[:60] for ev in events if ev.get("cat") == "kernel"})
    print(f"  path I trace: {os.path.getsize(path)} bytes, the scope 'pass-spmv-0', {ops}, device kernels "
          f"{kernels or 'none recorded'}")
    check(all(any(k in name for name in kernels) for k in K2_KERNELS),
          f"path I trace: K2's device kernels {K2_KERNELS} missing from the trace's kernels {kernels}")


def phase_path_i_dashboard_checks(i: PathI, csr, dash, cli) -> None:
    """Every grid and its stats equal ``ReorderHeatmap`` on host copies; the
    ``|values|`` grids of the natural and Gray orders equal a float64
    ``np.add.at`` on the host (rtol 1e-12); four sections; the CLI's file is
    the in-process HTML."""
    import numpy as np

    from sparsebase_tpu_torch import DenseArray
    from sparsebase_tpu_torch.ops.reorder import ReorderHeatmap

    check(cli.returncode == 0, f"path I visualizer CLI failed: {cli.stderr[-2000:]}")
    host = csr.to_host()
    b = DASHBOARD_PARTS
    ident = torch.arange(csr.nrows, dtype=csr.indices.dtype, device=csr.indptr.device)
    cpu_stats = {}  # the counts pass's, for both passes
    for weights, (viz, html) in dash.items():
        check(html.count('class="section"') == 1 + len(DASHBOARD_ORDERINGS), "path I dashboard: sections")
        orders = {"natural": ident, **{k: v[0] for k, v in viz._orderings.items()}}
        for label, order in orders.items():
            grid, stats = viz._density(order, order)
            if not weights:
                cpu_heat, cpu_stats[label] = ReorderHeatmap(b).get_heatmap_with_stats(
                    host, DenseArray(order.cpu()), DenseArray(order.cpu()))
                check_equal(f"path I dashboard grid ({label}) vs ReorderHeatmap on host copies",
                            torch.from_numpy(grid).view(-1), cpu_heat.vals)
            check(stats == cpu_stats[label], f"path I dashboard stats ({label}): card {stats}, CPU {cpu_stats[label]}")
            if weights and label in ("natural", "gray"):
                o = order.cpu().numpy().astype(np.int64)
                r, c = o[host.row_of_nnz().numpy()], o[host.indices.numpy()]
                want = np.zeros((b, b))
                np.add.at(want, (np.minimum(r * b // csr.nrows, b - 1), np.minimum(c * b // csr.ncols, b - 1)),
                          np.abs(host.vals.numpy()))
                rel = float(np.max(np.abs(grid - want) / np.maximum(np.abs(want), 1e-300)))
                print(f"  path I dashboard |values| grid ({label}) vs np.add.at in float64: max relative "
                      f"difference {rel:.3g}")
                check(np.allclose(grid, want, rtol=1e-12, atol=0), f"path I |values| grid ({label}) off rtol 1e-12")
    with open(i.cli_html) as f:
        check(f.read() == dash[False][1], "path I: the CLI's HTML differs from the in-process dashboard's")
    print("  path I visualizer CLI on the MTX file, on the card, in a subprocess: its HTML equal to the in-process "
          "dashboard's")


SUITE_TIME_FIELDS = ("convert_roundtrip_nnz_per_s", "seconds")


def without_times(entry):
    """A suite entry without its time fields (at any depth)."""
    if isinstance(entry, dict):
        return {k: without_times(v) for k, v in entry.items() if k not in SUITE_TIME_FIELDS}
    return entry


def phase_path_i_suite_checks(suite) -> None:
    """rand-20k on the card: every field that is not a time equal to
    ``run_matrix`` on a CPU copy."""
    from sparsebase_tpu_torch import bench_suite

    graph, entry = suite
    cpu = bench_suite.run_matrix(SUITE_MATRIX, graph.to_host())[SUITE_MATRIX]
    check(without_times(entry) == without_times(cpu),
          f"path I suite {SUITE_MATRIX}: the card's entry differs from the CPU's")
    print(f"  path I suite {SUITE_MATRIX}: the card's non-time fields equal run_matrix on a CPU copy")


def path_i(g, dev, nnz: int):
    """Path I's phases 3 and 4, after path H. Returns its launch counts and
    K2's largest difference from the plain SpMV."""
    from sparsebase_tpu_torch import _build

    with tempfile.TemporaryDirectory(prefix="chip_smoke_path_i_") as workdir:
        i = PathI(g, dev, nnz, workdir)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        exp, csr, dash, cli, suite = i.run()
        launches = read_launches("I", ("indptr", "radix_rank", "relocate_csr", "csr_spmv", "common_neighbors"))
        err = phase_path_i_experiment_checks(i, exp, csr)
        phase_path_i_sync_checks(i)
        phase_path_i_trace(i, csr)
        phase_path_i_dashboard_checks(i, csr, dash, cli)
        phase_path_i_suite_checks(suite)
    return launches, err


MESH_SHARDS = 4  # path J: four shards on the one card
HALO_CHECK_SHARDS = (4, 8)
REFINE_ROUNDS = 4
CC_HUB_SHARE = 0.01  # the components check's alive mask leaves out this share of vertices, the highest degrees first


class PathJ:
    """Path J: the distributed tier on a single-process mesh of four shards
    that share the one card (``make_mesh(devices=[cuda:0] * 4)``). On path
    A's COO: ``ShardedCSR.from_coo_sharded`` (route, K5, K3) and
    ``with_halo``; ``from_csr`` of path A's source CSR at d = 4 and d = 1;
    ``dist.spmv`` (K2 per shard) on the ingested container; every replicated
    function of ``dist`` (degrees, ``degree_reorder``, ``bfs_levels`` from
    0, ``rcm_reorder``, ``label_prop_partition`` (k = 8, 10 rounds),
    ``edge_cut``, ``refine_partition`` (4 rounds), ``structure_features``,
    ``reorder_heatmap`` (b = 8)) at d = 4 and at d = 1; beside them every
    function of ``halo`` (``spmv``, K2 per shard on its ``halo_map``
    columns; ``bfs_levels`` from 0; ``rcm_reorder``, K5 and K3 per shard in
    each counting rank; ``label_prop_partition`` (k = 8, 10 rounds);
    ``edge_cut``; ``refine_partition`` (4 rounds), K5 and K3 in each
    admission; ``connected_components``) at d = 4 and at d = 1 (``sh1``
    gets its halo lists); ``Sharded2DCSR`` on a 2×2 mesh of the card with
    its ``spmv`` (K2 per tile, ``psum_scatter``) and ``degrees``."""

    def __init__(self, g, dev, coo, src, x, host_graph):
        from sparsebase_tpu_torch.parallel import make_mesh, make_mesh_2d

        self.g, self.dev, self.coo, self.src, self.x, self.host_graph = g, dev, coo, src, x, host_graph
        self.mesh = make_mesh(devices=[dev] * MESH_SHARDS)
        self.mesh1 = make_mesh(devices=[dev])
        self.mesh2d = make_mesh_2d((2, 2), devices=[dev] * 4)
        self.ingest_stats = {}

    def ingest(self, mesh, stats=None):
        from sparsebase_tpu_torch.parallel import ShardedCSR

        c = self.coo
        return ShardedCSR.from_coo_sharded(c.row, c.col, c.vals, c.shape, mesh, stats=stats)

    def from_csr(self, mesh):
        from sparsebase_tpu_torch.parallel import ShardedCSR

        return ShardedCSR.from_csr(self.src, mesh, halo=False)

    def replicated(self, sh, mesh):
        """Every replicated function of ``dist`` on ``sh``, in call order."""
        from sparsebase_tpu_torch.parallel import dist

        n = sh.shape[0]
        ident = torch.arange(n, dtype=torch.int32, device=self.dev)
        lp = dist.label_prop_partition(sh, PARTITION_K, mesh, num_iters=PARTITION_ROUNDS)
        out = {"degrees": dist.degrees(sh, mesh), "degree_reorder": dist.degree_reorder(sh, mesh),
               "bfs_levels": dist.bfs_levels(sh, 0, mesh), "rcm_reorder": dist.rcm_reorder(sh, mesh),
               "label_prop_partition": lp, "edge_cut": dist.edge_cut(sh, lp, mesh),
               "refine_partition": dist.refine_partition(sh, lp, PARTITION_K, mesh, rounds=REFINE_ROUNDS),
               "reorder_heatmap": dist.reorder_heatmap(sh, ident, ident, mesh, num_parts=HEATMAP_PARTS)}
        out.update({f"structure {k}": v for k, v in dist.structure_features(sh, mesh).items()})
        return out

    def halo_results(self, sh, mesh):
        """Every function of ``halo`` on ``sh``, in call order."""
        from sparsebase_tpu_torch.parallel import halo

        n = sh.shape[0]
        lp = halo.label_prop_partition(sh, PARTITION_K, mesh, num_iters=PARTITION_ROUNDS)
        chunks = (torch.arange(n, device=self.dev) * PARTITION_K // n).to(torch.int32)  # within the cap
        return {"spmv": halo.spmv(sh, self.x, mesh), "bfs_levels": halo.bfs_levels(sh, 0, mesh),
                "rcm_reorder": halo.rcm_reorder(sh, mesh), "label_prop_partition": lp,
                "edge_cut": halo.edge_cut(sh, lp, mesh),
                "refine_partition": halo.refine_partition(sh, lp, PARTITION_K, mesh, rounds=REFINE_ROUNDS),
                "refine_partition of chunks": halo.refine_partition(sh, chunks, PARTITION_K, mesh,
                                                                    rounds=REFINE_ROUNDS),
                "connected_components": halo.connected_components(sh, mesh)}

    def run(self):
        from sparsebase_tpu_torch.parallel import Sharded2DCSR, dist, sharded2d

        sh = self.ingest(self.mesh, self.ingest_stats)
        halo = sh.with_halo()
        sh4, sh1 = self.from_csr(self.mesh), self.from_csr(self.mesh1).with_halo()
        y = dist.spmv(halo, self.x, self.mesh)
        rep4, rep1 = self.replicated(halo, self.mesh), self.replicated(sh1, self.mesh1)
        hal4, hal1 = self.halo_results(halo, self.mesh), self.halo_results(sh1, self.mesh1)
        tiles = Sharded2DCSR.from_csr(self.src, self.mesh2d)
        y2, deg2 = sharded2d.spmv(tiles, self.x, self.mesh2d), sharded2d.degrees(tiles, self.mesh2d)
        return sh, halo, sh4, y, rep4, rep1, hal4, hal1, tiles, y2, deg2


def shard_entries(sh, k):
    """Shard ``k``'s true entries ``(local row, col, val)`` in canonical order."""
    csr = sh.shard_csr(k)
    return canonical_entries(csr.row_of_nnz(), csr.indices, csr.vals)


def plain_bfs_levels(csr, root: int):
    """Level-synchronous BFS on the whole CSR by plain torch ops."""
    n = csr.nrows
    rows, cols = csr.row_of_nnz().long(), csr.indices.long()
    levels = torch.full((n,), -1, dtype=torch.int32, device=cols.device)
    levels[root] = 0
    frontier = levels == 0
    it = 0
    while bool(frontier.any()):
        reached = torch.zeros((n,), dtype=torch.bool, device=cols.device)
        reached[cols[frontier[rows]]] = True
        frontier = reached & (levels < 0)
        levels[frontier] = it + 1
        it += 1
    return levels


def plain_rcm(levels, deg):
    """The (level, degree, id) rank reversed over the reached vertices, by
    two stable ``torch.argsort`` s."""
    n = levels.numel()
    lev = torch.where(levels < 0, n, levels.long())
    order = torch.argsort(deg, stable=True)
    order = order[torch.argsort(lev[order], stable=True)]
    pos = torch.empty_like(order)
    pos[order] = torch.arange(n, device=order.device)
    reached = int((levels >= 0).sum())
    return torch.where(pos < reached, reached - 1 - pos, pos).to(torch.int32)


def plain_peripheral_root(csr, deg, passes: int = 2):
    """The root ``halo.rcm_reorder`` searches for, by plain BFS: from 0,
    ``passes`` times the least id among the least-degree vertices of the
    last level; returns it with its BFS levels."""
    root = 0
    for _ in range(passes):
        levels = plain_bfs_levels(csr, root)
        last = levels == levels.max()
        low = last & (deg == deg[last].min())
        root = int(torch.nonzero(low)[0])
    return root, plain_bfs_levels(csr, root)


def check_reversed_level_major(label: str, order, root: int, levels) -> None:
    """``order`` (``order[old] = new``) is a permutation that puts the
    vertices reached from ``root`` first, one contiguous range per BFS level
    with the levels in reverse order (``root`` last among them), and the
    unreached vertices after."""
    n = order.numel()
    check(bool((torch.bincount(order.long(), minlength=n) == 1).all()), f"{label}: not a permutation")
    reached = int((levels >= 0).sum())
    check(int(order[root]) == reached - 1, f"{label}: the root {root} sits at {int(order[root])}, not {reached - 1}")
    inv = torch.empty_like(order)
    inv[order.long()] = torch.arange(n, dtype=order.dtype, device=order.device)
    by_pos = levels[inv.long()]
    check(bool((by_pos[: reached - 1] >= by_pos[1:reached]).all()) and bool((by_pos[:reached] >= 0).all()),
          f"{label}: the reached vertices are not in reverse level order")
    check(bool((by_pos[reached:] == -1).all()), f"{label}: an unreached vertex sits among the reached")


def plain_components(csr, alive=None):
    """The min-label fixpoint by plain torch ops: each vertex's least
    component member (int32) in the graph induced by ``alive``, -1 outside."""
    n = csr.nrows
    rows, cols = csr.row_of_nnz().long(), csr.indices.long()
    ids = torch.arange(n, device=cols.device)
    if alive is not None:
        keep = alive[rows] & alive[cols]
        rows, cols, ids = rows[keep], cols[keep], torch.where(alive, ids, n)
    lab = ids
    while True:
        new = lab.scatter_reduce(0, rows, lab[cols], "amin")
        if torch.equal(new, lab):
            return torch.where(lab == n, -1, lab).to(torch.int32)
        lab = new


def components_graph(g, dev, n: int, nnz: int):
    """Path A's generator over ``PARTITION_K`` disjoint blocks
    (``planted_coo`` with every entry inside its block), mirrored: a
    symmetric CSR (duplicates kept) and the planted block of each vertex."""
    from sparsebase_tpu_torch import CSR
    from sparsebase_tpu_torch.convert.kernels import sort_by_pairs_plain
    from sparsebase_tpu_torch.ops.kernels import indptr_plain

    coo, planted = planted_coo(g, dev, n, nnz, inside=1.0)
    row, col = sort_by_pairs_plain(torch.cat([coo.row, coo.col]), torch.cat([coo.col, coo.row]))
    return CSR(indptr_plain(row, n), col, None, (n, n)), planted


def phase_path_j_components(j: PathJ) -> None:
    """``halo.connected_components`` on a mirrored 8-block graph of path
    A's size against the plain fixpoint, whole and with the highest-degree
    vertices masked out (SlashBurn's use), at d = 4 and d = 1."""
    from sparsebase_tpu_torch.parallel import ShardedCSR, halo

    n = j.src.nrows - j.src.nrows % PARTITION_K
    csr, planted = components_graph(j.g, j.dev, n, j.src.nnz // 2)
    deg = csr.degrees()
    alive = torch.ones((n,), dtype=torch.bool, device=j.dev)
    alive[torch.topk(deg, int(n * CC_HUB_SHARE)).indices] = False
    shards = {d: ShardedCSR.from_csr(csr, mesh) for d, mesh in ((MESH_SHARDS, j.mesh), (1, j.mesh1))}
    for label, mask in (("whole", None), (f"without the {CC_HUB_SHARE:.0%} of highest degree", alive)):
        want = plain_components(csr, mask)
        stats = {}
        got = halo.connected_components(shards[MESH_SHARDS], j.mesh, alive=mask, stats=stats)
        check_equal(f"path J halo.connected_components ({label}) vs the plain fixpoint", got, want)
        check_equal(f"path J halo.connected_components ({label}) at d=1 vs d={MESH_SHARDS}",
                    halo.connected_components(shards[1], j.mesh1, alive=mask), got)
        live = got >= 0
        check(bool((planted[live] == planted[got[live].long()]).all()),
              f"path J halo.connected_components ({label}): a component crosses the planted blocks")
        sizes = torch.bincount(got[live].long(), minlength=n)
        print(f"  path J halo.connected_components on the mirrored {PARTITION_K}-block graph ({csr.nnz} entries, "
              f"{label}): equal to the plain fixpoint at d={MESH_SHARDS} and d=1; {int((sizes > 0).sum())} components,"
              f" the largest {sorted(sizes.tolist(), reverse=True)[:PARTITION_K]}; {stats['rounds']} rounds, "
              f"{stats['jumps']} jumps, {stats['host_reads']} host reads")


def phase_path_j_halo_checks(j: PathJ, halo_sh, hal4, hal1, rep4) -> float:
    """The ``halo`` results against ``dist``'s and plain versions, and d = 4
    against d = 1; returns ``halo.spmv``'s largest difference from K2."""
    from sparsebase_tpu_torch.ops.kernels import csr_spmv, csr_spmv_plain
    from sparsebase_tpu_torch.parallel import dist

    src, n, d = j.src, j.src.nrows, MESH_SHARDS
    deg, absdot = src.degrees(), csr_spmv_plain(abs_csr(src), j.x.abs())
    err = check_rows("path J halo.spmv (K2 per shard on halo_map columns) vs K2 on the whole CSR", hal4["spmv"],
                     csr_spmv(src, j.x), deg, absdot)
    check_rows("path J halo.spmv d=1 vs K2 on the whole CSR", hal1["spmv"], csr_spmv(src, j.x), deg, absdot)
    ints = [name for name, t in hal4.items() if not t.dtype.is_floating_point]
    for name in ints:
        a, b = hal4[name], hal1[name]
        check(a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), f"path J halo.{name}: d={d} and d=1 differ")
    print(f"  path J: {len(ints)} halo results equal at d={d} and d=1: {sorted(ints)}")
    check_equal("path J halo.bfs_levels vs dist.bfs_levels", hal4["bfs_levels"], rep4["bfs_levels"])
    check_equal("path J halo.bfs_levels vs a plain level BFS", hal4["bfs_levels"], plain_bfs_levels(src, 0))
    lp, refined = hal4["label_prop_partition"], hal4["refine_partition"]
    check_equal("path J halo.edge_cut vs dist.edge_cut", hal4["edge_cut"], dist.edge_cut(halo_sh, lp, j.mesh))
    root, levels = plain_peripheral_root(src, deg)
    check_reversed_level_major("path J halo.rcm_reorder", hal4["rcm_reorder"], root, levels)
    rows = src.row_of_nnz().long()
    cut = lambda lab: int((lab[rows] != lab[src.indices.long()]).sum())  # noqa: E731
    chunks = (torch.arange(n, device=j.dev) * PARTITION_K // n).to(torch.int32)
    for name, lab in (("label_prop_partition", lp), ("refine_partition", refined),
                      ("refine_partition of chunks", hal4["refine_partition of chunks"])):
        check(lab.dtype == torch.int32 and int(lab.min()) >= 0 and int(lab.max()) < PARTITION_K,
              f"path J halo.{name}: labels outside [0, {PARTITION_K})")
    cap = 1.1 * n / PARTITION_K
    print(f"  path J halo: the RCM root {root} (level {int(levels.max())} the last); refinement against the cap "
          f"{cap:.1f}:")
    for name, before, after in (("label propagation's labels", lp, refined),
                                ("contiguous chunks", chunks, hal4["refine_partition of chunks"])):
        sizes_in, sizes_out = (torch.bincount(lab.long(), minlength=PARTITION_K) for lab in (before, after))
        fits = float(sizes_in.max()) <= cap
        if fits:
            check(cut(after) <= cut(before) and float(sizes_out.max()) <= cap,
                  f"path J halo.refine_partition of {name}: cut {cut(before)} -> {cut(after)}, largest part "
                  f"{int(sizes_out.max())} against the cap {cap:.1f}")
        print(f"    {name}: edge cut {cut(before)} -> {cut(after)}, part sizes {sizes_in.tolist()} -> "
              f"{sizes_out.tolist()}{'' if fits else ' (the input is over the cap: the cut is not held)'}")
    phase_path_j_components(j)
    return err


def phase_path_j_checks(j: PathJ, sh, halo, sh4, y, rep4, rep1, tiles, y2, deg2) -> float:
    """Returns K2's largest difference from the plain SpMV on path J."""
    from sparsebase_tpu_torch.ops.feature.structure import Bandwidth, Profile
    from sparsebase_tpu_torch.ops.kernels import csr_spmv, csr_spmv_plain, radix_rank_plain
    from sparsebase_tpu_torch.parallel import ShardedCSR, dist, make_mesh
    from sparsebase_tpu_torch.parallel.sharded import _build_halo, _pow2_at_least_64

    src, n, d = j.src, j.src.nrows, MESH_SHARDS
    print(f"phase 4 path J checks: n={n} nnz={src.nnz}, {d} shards on {sorted({str(x) for x in sh.devices})} "
          f"(the shards share one card), route capacity {j.ingest_stats['route_capacity']}, "
          f"w_c {j.ingest_stats['compacted_width']}")
    check(len(set(sh.devices)) == 1 and sh.n_shards == d, "path J: the ingest's shards are not all on the card")
    # the ingest holds from_csr's entries, shard by shard
    counts = sh4.nnz_counts
    check(sh.nnz_counts == counts and sh.rows_per_shard == sh4.rows_per_shard, f"path J ingest counts {sh.nnz_counts} "
          f"against from_csr's {counts}")
    check(sh4.width == max(counts) and sh.width == min(_pow2_at_least_64(max(counts)), d * j.ingest_stats[
        "route_capacity"]), f"path J widths: ingest {sh.width}, from_csr {sh4.width}, counts {counts}")
    for k in range(d):
        check_equal(f"path J shard {k} indptr, ingest vs from_csr", sh.indptr[k], sh4.indptr[k])
        for name, a, b in zip(("row", "col", "vals"), shard_entries(sh, k), shard_entries(sh4, k)):
            check_equal(f"path J shard {k} {name}, ingest vs from_csr (canonical order)", a, b)
    # with_halo against the host builder on path G's power-law graph
    for dh in HALO_CHECK_SHARDS:
        base = ShardedCSR.from_csr(j.host_graph, make_mesh(devices=[j.dev] * dh), halo=False)
        got = base.with_halo()
        want = _build_halo(base.stacked("indices").cpu().numpy(), base.nnz_counts, base.rows_per_shard, dh)
        for name, w in zip(("halo_send", "halo_counts", "halo_map"), want):
            g = got.stacked(name).cpu()
            check(g.shape == w.shape and bool((g.numpy() == w).all()),
                  f"path J with_halo {name} at d={dh} against _build_halo: shapes {tuple(g.shape)}, {w.shape}")
        print(f"  path J with_halo at d={dh} on the {j.host_graph.nrows}-vertex power-law graph equals _build_halo "
              f"(S={got.halo_width}, {got.halo_bytes_per_exchange} halo bytes)")
    # the SpMVs, within the reordered-sum bound
    deg, absdot = src.degrees(), csr_spmv_plain(abs_csr(src), j.x.abs())
    y_k2 = csr_spmv(src, j.x)
    err = check_rows("path J dist.spmv (K2 per shard) vs K2 on the whole CSR", y, y_k2, deg, absdot)
    err = max(err, check_rows("path J dist.spmv vs plain", y, csr_spmv_plain(src, j.x), deg, absdot))
    err = max(err, check_rows("path J Sharded2DCSR spmv (K2 per tile) vs K2", y2, y_k2, deg, absdot))
    check_equal("path J Sharded2DCSR degrees vs indptr", deg2, deg)
    check(tiles.nnz == src.nnz, f"path J Sharded2DCSR holds {tiles.nnz} entries of {src.nnz}")
    # d = 4 against d = 1, bit for bit, and against plain versions
    for name in rep4:
        a, b = rep4[name], rep1[name]
        check(a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), f"path J {name}: d={d} and d=1 differ")
    print(f"  path J: {len(rep4)} replicated results equal at d={d} and d=1: {sorted(rep4)}")
    check_equal("path J degrees vs indptr", rep4["degrees"], deg)
    check_equal("path J degree_reorder vs a stable argsort rank", rep4["degree_reorder"], radix_rank_plain(deg))
    levels = rep4["bfs_levels"]
    check_equal("path J bfs_levels vs a plain level BFS", levels, plain_bfs_levels(src, 0))
    check_equal("path J rcm_reorder vs a plain (level, degree, id) rank", rep4["rcm_reorder"], plain_rcm(levels, deg))
    lp, refined = rep4["label_prop_partition"], rep4["refine_partition"]
    rows = src.row_of_nnz().long()
    cut = lambda lab: (lab[rows] != lab[src.indices.long()]).sum()  # noqa: E731
    check_equal("path J edge_cut vs a plain count", rep4["edge_cut"], cut(lp))
    for name, lab in (("label_prop_partition", lp), ("refine_partition", refined)):
        check(lab.dtype == torch.int32 and int(lab.min()) >= 0 and int(lab.max()) < PARTITION_K,
              f"path J {name}: labels outside [0, {PARTITION_K})")
    check(int(cut(refined)) <= int(cut(lp)), "path J refine_partition raised the edge cut")
    want = {"bandwidth": Bandwidth().get_bandwidth(src), "profile": Profile().get_profile(src), "nnz": src.nnz,
            "min_degree": deg.min(), "max_degree": deg.max()}
    for name, w in want.items():
        check(int(rep4[f"structure {name}"]) == int(w), f"path J structure {name}: {int(rep4[f'structure {name}'])} "
              f"against {int(w)}")
    print(f"  path J structure features: { {k: float(v) for k, v in rep4.items() if k.startswith('structure')} }, "
          f"edge cut {int(rep4['edge_cut'])} -> refined {int(cut(refined))}, BFS levels {int(levels.max())}")
    ident = torch.arange(n, dtype=torch.int32, device=j.dev)
    from sparsebase_tpu_torch import ReorderBase

    host_grid = ReorderBase.heatmap(src, ident, ident, num_parts=HEATMAP_PARTS).vals.reshape(HEATMAP_PARTS, -1)
    check(torch.allclose(rep4["reorder_heatmap"], host_grid.to(torch.float32), rtol=1e-6, atol=0),
          "path J reorder_heatmap vs ReorderHeatmap")
    if torch.cuda.device_count() >= MESH_SHARDS:  # one shard per card
        cards = make_mesh(MESH_SHARDS)
        spread = j.ingest(cards)
        for k in range(MESH_SHARDS):
            check_equal(f"path J shard {k} indptr, {MESH_SHARDS} cards vs one", spread.indptr[k].to(j.dev), sh.indptr[k])
        check(torch.equal(dist.spmv(spread, j.x, cards), dist.spmv(sh, j.x, j.mesh)),
              "path J dist.spmv on four cards differs from one card")
    return err


def path_j(g, dev, coo, src, x, host_graph):
    """Path J's phases 3 and 4, after path I (the components check draws
    its graph from ``g``). Returns its launch counts, K2's largest
    difference from the plain SpMV and the path (path K takes its meshes)."""
    from sparsebase_tpu_torch import _build

    j = PathJ(g, dev, coo, src, x, host_graph)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    sh, halo, sh4, y, rep4, rep1, hal4, hal1, tiles, y2, deg2 = j.run()
    launches = read_launches("J", ("indptr", "radix_rank", "csr_spmv"))
    err = phase_path_j_checks(j, sh, halo, sh4, y, rep4, rep1, tiles, y2, deg2)
    err = max(err, phase_path_j_halo_checks(j, halo, hal4, hal1, rep4))
    return launches, err, j


# slashburn_reorder's k_size on POWER_LAW_CARD's graph: 1% of its vertices
# (0.5%, 45 rounds, until path O joined the script and it passed its 700 s
# budget). At the default 64 a round would take 64 hubs of 10^6 vertices,
# each of which keeps its 16 uniform columns on average: thousands of rounds
SLASHBURN_CARD_K = POWER_LAW_CARD[0] // 100
SLASHBURN_K = 64  # the default, on POWER_LAW_HOST's graph


def unique_pattern(csr):
    """The pattern of ``csr`` without repeated entries (SlashBurn's
    adjacency: the host route drops repeats), sorted by (row, column)."""
    from sparsebase_tpu_torch import CSR
    from sparsebase_tpu_torch.ops.kernels import indptr_plain

    n = csr.nrows
    keys = torch.unique(csr.row_of_nnz().long() * n + csr.indices.long())
    return CSR(indptr_plain((keys // n).to(torch.int32), n), (keys % n).to(torch.int32), None, csr.shape)


def bandwidth(row, col, order=None) -> int:
    """The largest |order[row] - order[col]| (the identity when ``order`` is
    None)."""
    if order is not None:
        row, col = order[row.long()], order[col.long()]
    return int((row.long() - col.long()).abs().max())


class PathK:
    """Path K: the multilevel half of ``halo`` on path J's meshes, four
    shards that share the one card and d = 1. On path A's generator over 8
    disjoint blocks, mirrored (50M entries, ``components_graph``):
    ``heavy_edge_matching`` weighted and on the pattern, one ``coarsen``
    with its map (K5 and K3 in the route), ``multilevel_partition`` (k = 8:
    the ladder, label propagation on the coarsest graph, refinement at every
    level, K5 and K3 in each admission). On path B's band scrambled
    (1,939,393 rows, 64M entries): ``bfs_levels_multilevel`` from 0 and
    ``rcm_reorder_ml`` (K5 in the rank). SlashBurn on the power-law graphs
    mirrored, repeated entries dropped: on ``POWER_LAW_CARD``'s with
    ``k_size`` = ``SLASHBURN_CARD_K`` and its other defaults, ``hub_order``
    off and on (K5 and K3 in each round's counting rank); on
    ``POWER_LAW_HOST``'s with its defaults and with every host tier and
    compaction off."""

    def __init__(self, g, dev, j: PathJ, n_blocks: int, nnz_blocks: int, band_n: int):
        self.g, self.dev = g, dev
        self.meshes = ((MESH_SHARDS, j.mesh), (1, j.mesh1))
        self.blocks, self.planted = components_graph(g, dev, n_blocks, nnz_blocks)
        self.band, self.band_perm = scrambled_band(g, dev, band_n, with_perm=True)
        self.sb_card = unique_pattern(power_law_pattern(g, dev, *POWER_LAW_CARD))
        self.sb_host = unique_pattern(power_law_pattern(g, dev, *POWER_LAW_HOST))

    def run(self):
        """Every function once at d = 4 and at d = 1: ``{d: {name: result}}``."""
        from sparsebase_tpu_torch import CSR
        from sparsebase_tpu_torch.parallel import ShardedCSR, halo

        band_csr = self.band.convert(CSR)
        out = {}
        for d, mesh in self.meshes:
            r = out[d] = {}
            sh = ShardedCSR.from_csr(self.blocks, mesh)
            r["match"] = halo.heavy_edge_matching(sh, mesh)
            r["match pattern"] = halo.heavy_edge_matching(sh, mesh, weighted=False)
            r["coarse"], r["map"] = halo.coarsen(sh, r["match"], mesh, return_mapping=True)
            r["coarse"] = r["coarse"].to_csr()
            r["ml stats"] = {}
            r["labels"] = halo.multilevel_partition(sh, PARTITION_K, mesh, stats=r["ml stats"])
            r["flat"] = halo.refine_partition(sh, halo.label_prop_partition(sh, PARTITION_K, mesh, num_iters=20),
                                              PARTITION_K, mesh, rounds=6)
            sh = ShardedCSR.from_csr(band_csr, mesh)
            r["bfs stats"] = {}
            r["levels"], r["steps"] = halo.bfs_levels_multilevel(sh, 0, mesh, stats=r["bfs stats"])
            r["rcm"], r["rcm steps"] = halo.rcm_reorder_ml(sh, mesh)
            sh = ShardedCSR.from_csr(self.sb_card, mesh)
            for hub_order in (False, True):
                st = r[f"sb card {hub_order}"] = {}
                r[f"slashburn card {hub_order}"] = halo.slashburn_reorder(
                    sh, mesh, k_size=SLASHBURN_CARD_K, hub_order=hub_order, stats=st)
            sh = ShardedCSR.from_csr(self.sb_host, mesh)
            for tier, kw in (("defaults", {}), ("on the mesh", dict(host_tail=0, host_tail_nnz=0, compact_ratio=0))):
                st = r[f"sb host {tier}"] = {}
                r[f"slashburn host {tier}"] = halo.slashburn_reorder(sh, mesh, stats=st, **kw)
        return out


def check_matching(label: str, csr, match) -> None:
    """``match`` is an involution whose pairs are entries of ``csr`` (whose
    columns are sorted within rows)."""
    n = csr.nrows
    ids = torch.arange(n, device=match.device)
    check(match.dtype == torch.int32 and bool((match.long()[match.long()] == ids).all()),
          f"{label}: the matching is not an involution")
    paired = match.long() != ids
    keys = csr.row_of_nnz().long() * n + csr.indices.long()
    want = ids[paired] * n + match.long()[paired]
    at = torch.searchsorted(keys, want).clamp(max=keys.numel() - 1)
    check(bool((keys[at] == want).all()), f"{label}: a matched pair is no entry of the graph")


def phase_path_k_checks(k: PathK, out) -> None:
    from sparsebase_tpu_torch.convert.kernels import sort_by_pairs_plain

    r, dev = out[MESH_SHARDS], k.dev
    for name in ("match", "match pattern", "map", "labels", "levels", "rcm", "slashburn card False",
                 "slashburn card True", "slashburn host defaults", "slashburn host on the mesh"):
        check_equal(f"path K {name}: d={MESH_SHARDS} vs d=1", r[name], out[1][name])
    for name in ("indptr", "indices", "vals"):
        check_equal(f"path K coarse {name}: d={MESH_SHARDS} vs d=1", getattr(r["coarse"], name),
                    getattr(out[1]["coarse"], name))
    check(r["steps"] == out[1]["steps"] == r["rcm steps"], "path K: the multilevel BFS's steps differ")
    # (a) the mirrored 8-block graph
    csr, n = k.blocks, k.blocks.nrows
    for name in ("match", "match pattern"):
        check_matching(f"path K heavy_edge_matching ({name})", csr, r[name])
    cid = r["map"].long()
    rows, cols = csr.row_of_nnz().long(), csr.indices.long()
    cu, cv = cid[rows], cid[cols]
    keep = cu != cv
    want = sort_by_pairs_plain(cu[keep].to(torch.int32), cv[keep].to(torch.int32))
    coarse = r["coarse"]
    got = sort_by_pairs_plain(coarse.row_of_nnz().to(torch.int32), coarse.indices)
    check(coarse.nrows == int(cid.max()) + 1, "path K coarsen: the coarse size is not the map's")
    check_equal("path K coarsen rows vs a plain contraction", got[0], want[0])
    check_equal("path K coarsen columns vs a plain contraction", got[1], want[1])
    check(bool((coarse.vals == 1).all()), "path K coarsen: a pattern's coarse value is not 1")
    matched = int((r["match"].long() != torch.arange(n, device=dev)).sum())
    lab, flat = r["labels"], r["flat"]
    sizes = torch.bincount(lab.long(), minlength=PARTITION_K)
    cap = 1.1 * n / PARTITION_K
    check(lab.dtype == torch.int32 and int(lab.min()) >= 0 and int(lab.max()) < PARTITION_K and
          float(sizes.max()) <= cap, f"path K multilevel_partition: part sizes {sizes.tolist()} against the cap {cap:.1f}")
    cut = lambda t: int((t[rows] != t[cols]).sum())  # noqa: E731
    st = r["ml stats"]
    print(f"phase 4 path K (a) on the mirrored {PARTITION_K}-block graph (n={n}, {csr.nnz} entries): the matchings "
          f"are involutions along entries, {matched} vertices matched (weighted), "
          f"{int((r['match pattern'].long() != torch.arange(n, device=dev)).sum())} (pattern); coarsen: "
          f"{coarse.nrows} coarse vertices, {coarse.nnz} entries, equal to the plain contraction; "
          f"multilevel_partition: {st['levels']} levels, sizes {st['sizes']}, parts {sizes.tolist()} (cap "
          f"{cap:.1f}), edge cut {cut(lab)} beside the planted 0 ({cut(k.planted)}) and label propagation with "
          f"refinement's {cut(flat)}; {st['host_reads']} host reads, {st['host_writes']} writes")
    # (b) the scrambled band
    levels, order = r["levels"], r["rcm"]
    nb = k.band.nrows
    check(bool((levels >= 0).all()), "path K bfs_levels_multilevel: a vertex of the band is unreached")
    check(bool((torch.bincount(order.long(), minlength=nb) == 1).all()), "path K rcm_reorder_ml: not a permutation")
    pos = torch.empty((nb,), dtype=torch.int64, device=dev)
    pos[k.band_perm.long()] = torch.arange(nb, device=dev)
    exact = torch.div((pos - pos[0]).abs() + BAND_HALF_WIDTH - 1, BAND_HALF_WIDTH, rounding_mode="floor")
    err = (levels.long() - exact).abs()
    bs = r["bfs stats"]
    print(f"phase 4 path K (b) on the scrambled band (n={nb}, {k.band.nnz} entries): every vertex reached; levels "
          f"up to {int(levels.max())} against the exact {int(exact.max())}, error largest {int(err.max())}, mean "
          f"{float(err.double().mean()):.3f}; {r['steps']} synchronous steps ({bs['levels']} contractions, sizes "
          f"{bs['sizes']}, coarse BFS depth {bs['coarse_depth']}, {bs['host_reads']} host reads) against the exact "
          f"BFS's {int(exact.max()) + 1} levels; rcm_reorder_ml a permutation, bandwidth "
          f"{bandwidth(k.band.row, k.band.col, order)} beside the band's {BAND_HALF_WIDTH} and the scrambled "
          f"{bandwidth(k.band.row, k.band.col)}")
    # (c) SlashBurn
    from sparsebase_tpu_torch import native

    card, kk = k.sb_card, SLASHBURN_CARD_K
    comp = plain_components(card)
    gcc = int(torch.bincount(comp.long()[comp >= 0]).argmax())
    alive = comp == gcc
    rows, cols = card.row_of_nnz().long(), card.indices.long()
    live = alive[rows] & alive[cols]
    deg = torch.zeros((card.nrows,), dtype=torch.int64, device=dev).index_add_(0, rows, live.long())
    deg = torch.where(alive, deg, -1)
    hubs = torch.argsort(-deg, stable=True)[:kk]
    for hub_order in (False, True):
        o = r[f"slashburn card {hub_order}"]
        check(bool((torch.bincount(o.long(), minlength=card.nrows) == 1).all()),
              f"path K slashburn_reorder (hub_order={hub_order}): not a permutation")
        check_equal(f"path K slashburn_reorder (hub_order={hub_order}): the first {kk} positions vs the {kk} highest "
                    f"degrees of the giant component", o[hubs], torch.arange(kk, dtype=torch.int32, device=dev))
        print(f"phase 4 path K (c) slashburn_reorder on POWER_LAW_CARD's graph (n={card.nrows}, {card.nnz} entries), "
              f"hub_order={hub_order}: a permutation, the hubs first; {r[f'sb card {hub_order}']}")
    host = k.sb_host
    want = native.slashburn(host.nrows, host.indptr.cpu(), host.indices.cpu(), SLASHBURN_K, False, False)
    for tier in ("defaults", "on the mesh"):
        check_equal(f"path K slashburn_reorder on POWER_LAW_HOST ({tier}) vs native.slashburn(greedy=False)",
                    r[f"slashburn host {tier}"].cpu(), want.to(torch.int32))
        print(f"phase 4 path K (c) slashburn_reorder on POWER_LAW_HOST's graph (n={host.nrows}, {host.nnz} entries), "
              f"{tier}: equal to native.slashburn(greedy=False); {r[f'sb host {tier}']}")


def path_k(g, dev, j: PathJ, n_blocks: int, nnz_blocks: int, band_n: int):
    """Path K's phases 3 and 4, after path J, on its meshes (the graphs draw
    from ``g``). Returns its launch counts."""
    from sparsebase_tpu_torch import _build

    k = PathK(g, dev, j, n_blocks, nnz_blocks, band_n)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    out = k.run()
    launches = read_launches("K", ("indptr", "radix_rank"))
    phase_path_k_checks(k, out)
    return launches


# path L: the rings. 128 disjoint cliques K_512 (n = 65,536): at d = 4 a
# shard's tile is 16,384 × 65,536 = 2^30 cells, MAX_DENSE_ELEMS exactly
PATH_L_CLIQUES = (128, 512)
PATH_L_N = 65_536  # (b): the uniform graph where dense and sparse meet
PATH_L_PAIRS = 16  # uniform pairs per vertex before mirroring


def clique_entries(g, dev, count: int, size: int, directed: bool = False):
    """``count`` disjoint cliques K_size, ids shuffled by a seeded
    permutation: every ordered pair (u, v), u != v, of a clique, or, where
    ``directed``, each pair once, oriented by a seeded coin. ``(row, col)``
    int32, in clique order."""
    n = count * size
    perm = torch.randperm(n, generator=g, device=dev)
    a = torch.arange(size, device=dev)
    i, j = a.repeat_interleave(size), a.repeat(size)
    keep = (i < j) if directed else (i != j)
    i, j = i[keep], j[keep]
    base = torch.arange(count, device=dev).repeat_interleave(i.numel()) * size
    u, v = base + i.repeat(count), base + j.repeat(count)
    if directed:
        flip = torch.rand(u.shape, generator=g, device=dev) < 0.5
        u, v = torch.where(flip, v, u), torch.where(flip, u, v)
    return perm[u].to(torch.int32), perm[v].to(torch.int32)


def uniform_simple(g, dev, n: int, per_vertex: int):
    """``n * per_vertex`` uniform pairs with u != v, mirrored, repeats
    dropped: ``(row, col)`` int32, sorted by (row, col)."""
    row, col = random_pairs(g, dev, n, n * per_vertex)
    keys = torch.unique(row.long() * n + col.long())
    return (keys // n).to(torch.int32), (keys % n).to(torch.int32)


def candidate_slots(csr) -> int:
    """The sparse ring's expansion of a CSR: Σ over its entries (u, v), u !=
    v, of min(deg u, deg v), the shorter list's candidates."""
    deg = csr.degrees().long()
    u, v = csr.row_of_nnz().long(), csr.indices.long()
    return int(torch.where(u != v, torch.minimum(deg[u], deg[v]), 0).sum())


class PathL:
    """Path L: ``parallel.ring`` on a mesh of four shards that share the one
    card (``make_mesh(devices=[cuda:0] * 4)``) and on d = 1, each graph
    ingested by ``ShardedCSR.from_coo_sharded`` (K5, K3) and held to K6 on
    the whole CSR (``TriangleCount``, ``TriangleCount(count_directed=True)``,
    ``JaccardWeights``), whose CSR ``COO.new`` and ``convert(CSR)`` build
    (K5, K3). (a) 128 disjoint cliques K_512, ids shuffled: the dense
    ring's ``triangle_count`` and ``jaccard_flat`` at d = 4, where a shard's
    tile is ``MAX_DENSE_ELEMS`` cells; the cliques with each pair oriented
    by a coin, ``triangle_count(directed=True)`` at d = 4 and its
    ``ValueError`` at d = 1. (b) A uniform simple graph of 65,536 vertices:
    both rings' four functions at d = 4; at d = 1, where the guard routes to
    the sparse ring, ``triangle_count`` and ``jaccard_flat``. (c)
    ``POWER_LAW_CARD``'s graph mirrored without repeats: ``triangle_count``
    and ``jaccard_flat`` at d = 4 and d = 1, both on the sparse ring (path
    P runs a uniform graph of 2^22 vertices across processes). (d)
    ``bench_suite.run_distributed(shards=4)`` on rand-20k."""

    def __init__(self, g, dev):
        from sparsebase_tpu_torch.parallel import make_mesh

        self.dev = dev
        self.meshes = {MESH_SHARDS: make_mesh(devices=[dev] * MESH_SHARDS), 1: make_mesh(devices=[dev])}
        n_cliques = PATH_L_CLIQUES[0] * PATH_L_CLIQUES[1]
        card = unique_pattern(power_law_pattern(g, dev, *POWER_LAW_CARD))
        self.graphs = {  # name -> ((row, col), n)
            "cliques": (clique_entries(g, dev, *PATH_L_CLIQUES), n_cliques),
            "cliques directed": (clique_entries(g, dev, *PATH_L_CLIQUES, directed=True), n_cliques),
            "uniform 65,536": (uniform_simple(g, dev, PATH_L_N, PATH_L_PAIRS), PATH_L_N),
            "power law": ((card.row_of_nnz(), card.indices), card.nrows),
        }
        del card

    def sharded(self, name: str, d: int):
        from sparsebase_tpu_torch.parallel import ShardedCSR

        (row, col), n = self.graphs[name]
        return ShardedCSR.from_coo_sharded(row, col, None, (n, n), self.meshes[d])

    def run(self):
        """Every ring call once and the oracles: ``{graph: {key: result}}``."""
        from sparsebase_tpu_torch import COO, CSR, bench_suite
        from sparsebase_tpu_torch.ops.feature import JaccardWeights, TriangleCount
        from sparsebase_tpu_torch.parallel import ring

        plan = {  # graph -> [(d, function)]
            "cliques": [(MESH_SHARDS, "triangle_count"), (MESH_SHARDS, "jaccard_flat")],
            "cliques directed": [(MESH_SHARDS, "triangle_count directed")],
            "uniform 65,536": [(MESH_SHARDS, "triangle_count"), (MESH_SHARDS, "jaccard_weights"),
                               (MESH_SHARDS, "triangle_count_sparse"), (MESH_SHARDS, "jaccard_weights_sparse"),
                               (1, "triangle_count"), (1, "jaccard_flat")],
            "power law": [(d, f) for d in (MESH_SHARDS, 1) for f in ("triangle_count", "jaccard_flat")],
        }
        functions = {
            "triangle_count": ring.triangle_count,
            "triangle_count directed": lambda sh, m: ring.triangle_count(sh, m, directed=True),
            "triangle_count_sparse": ring.triangle_count_sparse,
            "jaccard_weights": ring.jaccard_weights,
            "jaccard_weights_sparse": ring.jaccard_weights_sparse,
            "jaccard_flat": ring.jaccard_flat,
        }
        out = {}
        for name, calls in plan.items():
            (row, col), n = self.graphs[name]
            r = out[name] = {}
            csr = COO.new(row, col, None, (n, n)).convert(CSR)
            r["csr"] = csr
            directed = name == "cliques directed"
            r["K6 triangles"] = TriangleCount(directed).get_triangle_count(csr)
            if not directed:
                r["K6 jaccard"] = JaccardWeights().get_jaccard_weights(csr).vals
            shards = {d: self.sharded(name, d) for d in sorted({d for d, _ in calls} | ({1} if directed else set()))}
            r["shards"] = shards
            for d, f in calls:
                r[(d, f)] = functions[f](shards[d], self.meshes[d])
            if directed:
                try:
                    ring.triangle_count(shards[1], self.meshes[1], directed=True)
                    r["d=1 raised"] = None
                except ValueError as err:
                    r["d=1 raised"] = str(err)
            r["sizes"] = {d: ring._sparse_sizes(sh, self.meshes[d]) for d, sh in shards.items()}
        out["suite"] = bench_suite.run_distributed(shards=MESH_SHARDS)
        return out


def flat_of(padded, sh):
    """Per-shard padded weights joined in the global entry order."""
    return torch.cat([padded[k][: sh.nnz_counts[k]] for k in range(len(padded))])


def phase_path_l_checks(out) -> None:
    """Every count equal to K6's, every weight to K6's bit for bit, d = 4
    equal to d = 1, and the closed forms."""
    from sparsebase_tpu_torch import bench_suite

    d4 = MESH_SHARDS
    a, ad = out["cliques"], out["cliques directed"]
    count, size = PATH_L_CLIQUES
    want = count * (size * (size - 1) * (size - 2) // 6)  # 2,846,556,160 > 2^31 for 128 K_512
    check(a[(d4, "triangle_count")] == want == a["K6 triangles"],
          f"path L (a): {a[(d4, 'triangle_count')]} triangles on the cliques, K6 {a['K6 triangles']}, want {want}")
    flat = a[(d4, "jaccard_flat")]
    check(bool((flat == torch.tensor((size - 2) / size, dtype=torch.float32, device=flat.device)).all()),
          f"path L (a): a clique's weight is not {size - 2}/{size}")
    check_equal("path L (a) jaccard_flat vs K6 JaccardWeights", flat, a["K6 jaccard"])
    check(ad[(d4, "triangle_count directed")] == ad["K6 triangles"],
          f"path L (a): directed {ad[(d4, 'triangle_count directed')]} against K6's {ad['K6 triangles']}")
    check(ad["d=1 raised"] is not None and "directed" in ad["d=1 raised"],
          "path L (a): the directed count at d = 1 did not raise the guard's ValueError")
    print(f"phase 4 path L (a) {PATH_L_CLIQUES[0]} cliques K_{PATH_L_CLIQUES[1]} (n={a['csr'].nrows}, "
          f"{a['csr'].nnz} entries): {a[(d4, 'triangle_count')]} triangles, every weight {size - 2}/{size} and equal to "
          f"K6's; "
          f"directed {ad[(d4, 'triangle_count directed')]} 3-cycles equal to K6's ({ad['csr'].nnz} entries); d=1 "
          f"raised: {ad['d=1 raised']!r}")
    b = out["uniform 65,536"]
    sh4 = b["shards"][d4]
    tri = [b[(d4, "triangle_count")], b[(d4, "triangle_count_sparse")], b[(1, "triangle_count")]]
    check(tri == [b["K6 triangles"]] * 3, f"path L (b): dense, sparse, d=1 {tri} against K6's {b['K6 triangles']}")
    for label, got in (("jaccard_weights", flat_of(b[(d4, "jaccard_weights")], sh4)),
                       ("jaccard_weights_sparse", flat_of(b[(d4, "jaccard_weights_sparse")], sh4)),
                       ("jaccard_flat d=1", b[(1, "jaccard_flat")])):
        check_equal(f"path L (b) {label} vs K6 JaccardWeights", got, b["K6 jaccard"])
    print(f"phase 4 path L (b) uniform (n={b['csr'].nrows}, {b['csr'].nnz} entries): {tri[0]} triangles, dense, "
          f"sparse and d=1 equal to K6; the weights of both rings and of d=1 equal to K6's bit for bit")
    for name in ("power law",):
        c = out[name]
        tri = [c[(d, "triangle_count")] for d in (d4, 1)]
        check(tri == [c["K6 triangles"]] * 2, f"path L (c) {name}: {tri} against K6's {c['K6 triangles']}")
        for d in (d4, 1):
            check_equal(f"path L (c) {name} jaccard_flat d={d} vs K6 JaccardWeights", c[(d, "jaccard_flat")],
                        c["K6 jaccard"])
        print(f"phase 4 path L (c) {name} (n={c['csr'].nrows}, {c['csr'].nnz} entries): {tri[0]} triangles at d=4 "
              f"and d=1, equal to K6, the weights equal to K6's bit for bit; _sparse_sizes {c['sizes']}; "
              f"{candidate_slots(c['csr'])} candidate slots")
    card = out["suite"]
    host = bench_suite.run_distributed(device="cpu", shards=MESH_SHARDS)
    check(without_times(card) == without_times(host), f"path L (d) run_distributed on the card {card} vs the CPU {host}")
    print(f"phase 4 path L (d) run_distributed(shards={MESH_SHARDS}) on the card equal, but for times, to the CPU "
          f"call: {json.dumps(card)}")


def path_l(g, dev):
    """Path L's phases 3 and 4, after path K (the graphs draw from ``g``).
    Returns its launch counts and (d)'s table, which path P holds the
    processes' tables to."""
    from sparsebase_tpu_torch import _build

    p = PathL(g, dev)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    out = p.run()
    launches = read_launches("L", ("indptr", "radix_rank", "common_neighbors"))
    phase_path_l_checks(out)
    return launches, out["suite"]


# -- path M: the distributed ingest's path across processes --------------------
PATH_M_N = 1 << 22  # tools/multiproc_dcn.py's graph at 2^22 vertices, average degree 8: about 33.5M entries
PATH_M_AVG_DEG = 8
PATH_M_SHARDS = 4  # the single-process reference: four shards of the card
PATH_M_PROCESSES = 2  # the group: two gloo processes sharing the card, two shards each
PATH_M_TIME_LIMIT = 300  # seconds for the group, start-up included
PATH_M_FIELDS = ("indptr", "indices", "vals", "nnz_local", "halo_send", "halo_counts", "halo_map")
def tool_graph(dev, n: int, avg_deg: int, seed: int):
    """``tools/multiproc_dcn.py``'s graph made on ``dev`` from a generator of
    its own (every process of path M makes the same): ``n * avg_deg / 2``
    uniform pairs without self-loops, mirrored, unique, row-major, standard
    normal float32 values; then x. Returns ``(row, col, vals, x)``."""
    from sparsebase_tpu_torch.ops.kernels.radix import bits_below, radix_unique

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    pairs = n * avg_deg // 2
    r = torch.randint(0, n, (pairs,), generator=g, device=dev)
    c = torch.randint(0, n, (pairs,), generator=g, device=dev)
    keep = r != c
    r, c = r[keep], c[keep]
    keys = radix_unique(torch.cat([r * n + c, c * n + r]), key_bits=bits_below(n * n))
    vals = torch.randn((keys.numel(),), generator=g, device=dev)
    x = torch.randn((n,), generator=g, device=dev)
    return (keys // n).to(torch.int32), (keys % n).to(torch.int32), vals, x


def path_m_run(mesh, row, col, vals, x):
    """The tool's path on ``mesh``: ``from_coo_sharded`` → ``with_halo`` →
    ``halo.spmv`` → ``dist.rcm_reorder``. Returns ``(sharded, y, order, the
    ingest's stats)``."""
    from sparsebase_tpu_torch.parallel import ShardedCSR, dist, halo

    n = x.numel()
    stats = {}
    sh = ShardedCSR.from_coo_sharded(row, col, vals, (n, n), mesh, stats=stats).with_halo()
    y = halo.spmv(sh, x, mesh)
    return sh, y, dist.rcm_reorder(sh, mesh), stats


# -- path N: the rest of dist and halo's flat half across processes ----------
PATH_N_KERNELS = ("indptr", "radix_rank", "csr_spmv")  # K3, K5, K2


def path_n_run(sh, mesh, x) -> tuple:
    """Path N: the twelve functions of ``dist`` and ``halo`` that path M's
    processes did not run yet, with path J's arguments, on path M's
    container ``sh`` (``halo.refine_partition`` also refines the contiguous
    chunks, as path J does). Returns ``(results, stats)`` by function."""
    from sparsebase_tpu_torch.parallel import dist, halo

    n, dev = sh.shape[0], mesh.first_device
    ident = torch.arange(n, dtype=torch.int32, device=dev)
    chunks = (torch.arange(n, device=dev) * PARTITION_K // n).to(torch.int32)  # within the cap
    results, stats = {}, {}

    def phase(name, fn):
        stats[name] = {}
        results[name] = out = fn(stats[name])
        return out

    phase("dist.spmv", lambda st: dist.spmv(sh, x, mesh))
    lp = phase("dist.label_prop_partition",
               lambda st: dist.label_prop_partition(sh, PARTITION_K, mesh, num_iters=PARTITION_ROUNDS))
    phase("dist.edge_cut", lambda st: dist.edge_cut(sh, lp, mesh))
    phase("dist.refine_partition", lambda st: dist.refine_partition(sh, lp, PARTITION_K, mesh, rounds=REFINE_ROUNDS))
    phase("dist.structure_features", lambda st: dist.structure_features(sh, mesh))
    phase("dist.reorder_heatmap", lambda st: dist.reorder_heatmap(sh, ident, ident, mesh, num_parts=HEATMAP_PARTS))
    phase("halo.bfs_levels", lambda st: halo.bfs_levels(sh, 0, mesh, stats=st))
    hlp = phase("halo.label_prop_partition",
                lambda st: halo.label_prop_partition(sh, PARTITION_K, mesh, num_iters=PARTITION_ROUNDS))
    phase("halo.connected_components", lambda st: halo.connected_components(sh, mesh, stats=st))
    phase("halo.rcm_reorder", lambda st: halo.rcm_reorder(sh, mesh, stats=st))
    phase("halo.edge_cut", lambda st: halo.edge_cut(sh, hlp, mesh))
    phase("halo.refine_partition", lambda st: halo.refine_partition(sh, hlp, PARTITION_K, mesh, rounds=REFINE_ROUNDS))
    phase("halo.refine_partition of chunks",
          lambda st: halo.refine_partition(sh, chunks, PARTITION_K, mesh, rounds=REFINE_ROUNDS))
    return results, stats


def on_host(result):
    """A result (a tensor, or dicts and tuples of them) copied to host memory."""
    if isinstance(result, dict):
        return {k: on_host(v) for k, v in result.items()}
    if isinstance(result, tuple):
        return tuple(on_host(v) for v in result)
    return result.cpu() if isinstance(result, torch.Tensor) else result


def path_n_checks(sh, mesh, src, x, res) -> float:
    """Path N's results on one process held to references that do not lean
    on the port's multi-shard route; returns ``dist.spmv``'s largest
    difference from the plain SpMV."""
    from sparsebase_tpu_torch import ReorderBase
    from sparsebase_tpu_torch.ops.feature.structure import Bandwidth, Profile
    from sparsebase_tpu_torch.ops.kernels import csr_spmv_plain
    from sparsebase_tpu_torch.parallel import dist

    n, deg = src.nrows, src.degrees()
    print(f"phase 4 path N checks: the twelve functions on one process of {PATH_M_SHARDS} shards, n={n} nnz={src.nnz}")
    err = check_rows("path N dist.spmv (K2 per shard) vs plain SpMV of the whole CSR", res["dist.spmv"],
                     csr_spmv_plain(src, x), deg, csr_spmv_plain(abs_csr(src), x.abs()))
    check_equal("path N halo.bfs_levels vs dist.bfs_levels", res["halo.bfs_levels"], dist.bfs_levels(sh, 0, mesh))
    check_equal("path N halo.edge_cut vs dist.edge_cut of the same labels", res["halo.edge_cut"],
                dist.edge_cut(sh, res["halo.label_prop_partition"], mesh))
    rows, cols = src.row_of_nnz().long(), src.indices.long()
    cut = lambda lab: (lab[rows] != lab[cols]).sum()  # noqa: E731
    check_equal("path N dist.edge_cut vs a plain count", res["dist.edge_cut"], cut(res["dist.label_prop_partition"]))
    feats = res["dist.structure_features"]
    want = {"bandwidth": Bandwidth().get_bandwidth(src), "profile": Profile().get_profile(src), "nnz": src.nnz,
            "min_degree": deg.min(), "max_degree": deg.max()}
    for name, w in want.items():
        check(int(feats[name]) == int(w), f"path N structure {name}: {int(feats[name])} against {int(w)}")
    ident = torch.arange(n, dtype=torch.int32, device=x.device)
    grid = ReorderBase.heatmap(src, ident, ident, num_parts=HEATMAP_PARTS).vals.reshape(HEATMAP_PARTS, -1)
    check(torch.allclose(res["dist.reorder_heatmap"], grid.to(torch.float32), rtol=1e-6, atol=0),
          "path N dist.reorder_heatmap vs ReorderBase.heatmap")
    check_equal("path N halo.connected_components vs the plain fixpoint", res["halo.connected_components"],
                plain_components(src))
    root, levels = plain_peripheral_root(src, deg)
    check_reversed_level_major("path N halo.rcm_reorder", res["halo.rcm_reorder"], root, levels)
    cap = 1.1 * n / PARTITION_K
    chunks = (torch.arange(n, device=x.device) * PARTITION_K // n).to(torch.int32)
    for name, before, after in (("dist.refine_partition", res["dist.label_prop_partition"], res["dist.refine_partition"]),
                                ("halo.refine_partition", res["halo.label_prop_partition"], res["halo.refine_partition"]),
                                ("halo.refine_partition of chunks", chunks, res["halo.refine_partition of chunks"])):
        for lab in (before, after):
            check(lab.dtype == torch.int32 and int(lab.min()) >= 0 and int(lab.max()) < PARTITION_K,
                  f"path N {name}: labels outside [0, {PARTITION_K})")
        sizes_in, sizes_out = (torch.bincount(lab.long(), minlength=PARTITION_K) for lab in (before, after))
        fits = float(sizes_in.max()) <= cap
        if fits:  # a refinement keeps a labelling within the cap there and lowers no cut
            check(float(sizes_out.max()) <= cap and int(cut(after)) <= int(cut(before)),
                  f"path N {name}: cut {int(cut(before))} -> {int(cut(after))}, largest part {int(sizes_out.max())} "
                  f"against the cap {cap:.1f}")
        print(f"  path N {name}: edge cut {int(cut(before))} -> {int(cut(after))}, part sizes {sizes_in.tolist()} -> "
              f"{sizes_out.tolist()}, cap {cap:.1f}{'' if fits else ' (the input is over the cap: not held)'}")
    print(f"  path N structure features {({k: float(v) for k, v in feats.items()})}; components "
          f"{int(torch.unique(res['halo.connected_components']).numel())}; the RCM root {root}, "
          f"{int(levels.max()) + 1} levels")
    return err


# -- path O: halo's multilevel half, SlashBurn and the containers across processes
# the ladders' graph: tools/multiproc_dcn.py's at 2^17 vertices, average
# degree 8 (2^18 until the first whole run of the script passed 700 s)
PATH_O_N = 1 << 17
PATH_O_COARSEN_UNTIL = PATH_O_N // 16  # where the ladders stop contracting (or at their 24 levels)
# on POWER_LAW_HOST's graph with host_tail_nnz=0: 14 rounds on the mesh, 2
# compactions, then graphkit's host tail of about 62,000 vertices (a CPU
# probe of the same generator); k = 64 takes about 180 rounds
PATH_O_SLASHBURN_K = 1024
PATH_O_KERNELS = ("indptr", "radix_rank", "relocate_csr")  # K3, K5, K4


def path_o_sizes() -> tuple:
    """Path O's sizes, which the parent passes to the group's processes
    (``--path-o-sizes``): the ladders' vertices and ``coarsen_until``,
    SlashBurn's graph (vertices, entries before mirroring) and its
    ``k_size``."""
    return (PATH_O_N, PATH_O_COARSEN_UNTIL, *POWER_LAW_HOST, PATH_O_SLASHBURN_K)


def path_o_inputs(dev, mesh, seed: int, sizes: tuple) -> dict:
    """Path O's own graphs at ``sizes`` (:func:`path_o_sizes`), the same on
    every process: the ladders' (``tool_graph`` from ``seed + 1``) as a
    container with halo lists and as a CSR, and SlashBurn's
    (``power_law_pattern`` from ``seed``, mirrored, repeats dropped) as a
    CSR and its container (``ShardedCSR.from_csr``), with the ladders'
    ``coarsen_until`` and SlashBurn's k."""
    from sparsebase_tpu_torch import CSR
    from sparsebase_tpu_torch.ops.kernels import indptr_plain
    from sparsebase_tpu_torch.parallel import ShardedCSR

    n, until, sb_n, sb_nnz, k = sizes
    row, col, vals, _ = tool_graph(dev, n, PATH_M_AVG_DEG, seed + 1)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    sb = unique_pattern(power_law_pattern(g, dev, sb_n, sb_nnz))
    return {"ladder": ShardedCSR.from_coo_sharded(row, col, vals, (n, n), mesh).with_halo(),
            "ladder csr": CSR(indptr_plain(row, n), col, vals, (n, n)),
            "slashburn": ShardedCSR.from_csr(sb, mesh), "slashburn csr": sb, "coarsen until": until,
            "slashburn k": k}


def path_o_run(sh, src, inputs, mesh) -> tuple:
    """Path O: on path M's container ``sh`` and its CSR ``src``,
    ``heavy_edge_matching`` (weighted), ``coarsen`` of that matching with
    its map, ``ShardedCSR.from_csr`` and ``from_csr_balanced``; on the
    ladders' graph (:func:`path_o_inputs`), ``bfs_levels_multilevel`` from 0
    and ``rcm_reorder_ml`` down to its ``coarsen_until`` and
    ``multilevel_partition`` (k = ``PARTITION_K``, its defaults); SlashBurn
    (its k, ``host_tail_nnz=0``) with ``hub_order`` off and on. Returns
    ``(results, stats)`` by function."""
    from sparsebase_tpu_torch.parallel import ShardedCSR, halo

    results, stats = {}, {}

    def phase(name, fn):
        stats[name] = {}
        results[name] = fn(stats[name])

    phase("halo.heavy_edge_matching", lambda st: halo.heavy_edge_matching(sh, mesh))
    phase("halo.coarsen", lambda st: halo.coarsen(sh, results["halo.heavy_edge_matching"], mesh, return_mapping=True,
                                                  stats=st))
    phase("ShardedCSR.from_csr", lambda st: ShardedCSR.from_csr(src, mesh))
    phase("ShardedCSR.from_csr_balanced", lambda st: ShardedCSR.from_csr_balanced(src, mesh))
    lad, sb, until, k_size = (inputs[k] for k in ("ladder", "slashburn", "coarsen until", "slashburn k"))
    phase("halo.bfs_levels_multilevel", lambda st: halo.bfs_levels_multilevel(lad, 0, mesh, coarsen_until=until,
                                                                              stats=st))
    phase("halo.rcm_reorder_ml", lambda st: halo.rcm_reorder_ml(lad, mesh, coarsen_until=until, stats=st))
    phase("halo.multilevel_partition", lambda st: halo.multilevel_partition(lad, PARTITION_K, mesh, stats=st))
    for hub_order in (False, True):
        phase(f"halo.slashburn_reorder hub_order={hub_order}", lambda st, h=hub_order: halo.slashburn_reorder(
            sb, mesh, k_size=k_size, hub_order=h, host_tail_nnz=0, stats=st))
    return results, stats


def sharded_record(sh) -> dict:
    """A container as :func:`same` compares it: this process's shards'
    fields, the counts, shape and widths."""
    fields = [name for name in PATH_M_FIELDS if getattr(sh, name) is not None]
    return {"shards": {k: {name: getattr(sh, name)[k] for name in fields} for k in sh.local},
            "nnz_counts": sh.nnz_counts, "shape": sh.shape, "width": sh.width, "halo_width": sh.halo_width}


def path_o_record(results):
    """Path O's results with every container as its :func:`sharded_record`."""
    from sparsebase_tpu_torch.parallel import ShardedCSR

    if isinstance(results, ShardedCSR):
        return sharded_record(results)
    if isinstance(results, dict):
        return {k: path_o_record(v) for k, v in results.items()}
    if isinstance(results, tuple):
        return tuple(path_o_record(r) for r in results)
    return results


def same(got, want, local) -> bool:
    """``got`` (a process's) equal to ``want`` (the one process's) bit for
    bit: tensors with their dtypes and shapes, dicts key by key, tuples item
    by item; of a container's shards exactly the process's own (``local``)."""
    if isinstance(want, torch.Tensor):
        return (isinstance(got, torch.Tensor) and got.dtype == want.dtype and got.shape == want.shape
                and torch.equal(got.to(want.device), want))
    if isinstance(want, dict):
        if "shards" in want:
            rest = lambda r: {k: v for k, v in r.items() if k != "shards"}  # noqa: E731
            return (sorted(got["shards"]) == list(local) and same(rest(got), rest(want), local)
                    and all(same(got["shards"][k], want["shards"][k], local) for k in local))
        return set(got) == set(want) and all(same(got[k], want[k], local) for k in want)
    if isinstance(want, tuple):
        return isinstance(got, tuple) and len(got) == len(want) and all(same(g, w, local) for g, w in zip(got, want))
    return got == want


def path_o_checks(src, inputs, res) -> None:
    """Path O's results on one process held to references that do not lean
    on the multi-shard route (path K's checks)."""
    from sparsebase_tpu_torch import ReorderBase, native
    from sparsebase_tpu_torch.convert.kernels import sort_by_pairs_plain

    n, lad = src.nrows, inputs["ladder csr"]
    print(f"phase 4 path O checks on one process of {PATH_M_SHARDS} shards: path M's graph (n={n}, {src.nnz} "
          f"entries), the ladders' (n={lad.nrows}, {lad.nnz} entries), SlashBurn's "
          f"(n={inputs['slashburn csr'].nrows}, {inputs['slashburn csr'].nnz} entries)")
    match = res["halo.heavy_edge_matching"]
    check_matching("path O heavy_edge_matching", src, match)
    coarse, cid = res["halo.coarsen"]
    coarse, cid = coarse.to_csr(), cid.long()
    rows, cols = src.row_of_nnz().long(), src.indices.long()
    cu, cv = cid[rows], cid[cols]
    keep = cu != cv
    want = canonical_entries(*sort_by_pairs_plain(cu[keep].to(torch.int32), cv[keep].to(torch.int32), src.vals[keep]))
    got = canonical_entries(coarse.row_of_nnz().to(torch.int32), coarse.indices, coarse.vals)
    check(coarse.nrows == int(cid.max()) + 1, "path O coarsen: the coarse size is not the map's")
    for name, a, b in zip(("rows", "columns", "values"), got, want):
        check_equal(f"path O coarsen {name} vs a plain contraction by the map", a, b)
    print(f"  path O: {int((match.long() != torch.arange(n, device=match.device)).sum())} vertices matched; "
          f"coarsen {coarse.nrows} coarse vertices, {coarse.nnz} entries")
    back = res["ShardedCSR.from_csr"].to_csr()
    for name in ("indptr", "indices", "vals"):
        want = getattr(src, name)
        check_equal(f"path O from_csr(...).to_csr() {name} vs the source", getattr(back, name).to(want.dtype), want)
    balanced, order = res["ShardedCSR.from_csr_balanced"]
    back, want = balanced.to_csr(), ReorderBase.permute2d(order, src)
    for name in ("indptr", "indices", "vals"):
        check_equal(f"path O from_csr_balanced(...).to_csr() {name} vs ReorderBase.permute2d(order, src)",
                    getattr(back, name).to(getattr(want, name).dtype), getattr(want, name))
    print(f"  path O padded width ratio: from_csr {res['ShardedCSR.from_csr'].padded_width_ratio():.4f}, "
          f"from_csr_balanced {balanced.padded_width_ratio():.4f}")
    levels, steps = res["halo.bfs_levels_multilevel"]
    plain = plain_bfs_levels(lad, 0)
    check_equal("path O bfs_levels_multilevel: the vertices reached vs plain_bfs_levels", levels >= 0, plain >= 0)
    order, rcm_steps = res["halo.rcm_reorder_ml"]
    check(steps == rcm_steps and bool((torch.bincount(order.long(), minlength=lad.nrows) == 1).all()),
          "path O rcm_reorder_ml: not a permutation, or its steps differ from the BFS's")
    lab = res["halo.multilevel_partition"]
    sizes = torch.bincount(lab.long(), minlength=PARTITION_K)
    cap = 1.1 * lad.nrows / PARTITION_K
    check(lab.dtype == torch.int32 and int(lab.min()) >= 0 and int(lab.max()) < PARTITION_K
          and float(sizes.max()) <= cap,
          f"path O multilevel_partition: part sizes {sizes.tolist()} against the cap {cap:.1f}")
    lrows, lcols = lad.row_of_nnz().long(), lad.indices.long()
    print(f"  path O ladders: levels up to {int(levels.max())} against the exact {int(plain.max())}, {steps} "
          f"synchronous steps against the exact BFS's {int(plain.max()) + 1} levels; rcm_reorder_ml a permutation; "
          f"multilevel_partition parts {sizes.tolist()} (cap {cap:.1f}), edge cut "
          f"{int((lab.long()[lrows] != lab.long()[lcols]).sum())}")
    host, k_size = inputs["slashburn csr"], inputs["slashburn k"]
    for hub_order in (False, True):
        want = native.slashburn(host.nrows, host.indptr.cpu(), host.indices.cpu(), k_size, False, hub_order)
        check_equal(f"path O slashburn_reorder (hub_order={hub_order}) vs native.slashburn(greedy=False)",
                    res[f"halo.slashburn_reorder hub_order={hub_order}"].cpu(), want.to(torch.int32))


# -- path P: the rings, sharded2d, the containers and the harness across processes
# (a): 32 disjoint cliques K_512 (n = 16,384): at d = 4 a shard's tile is
# 4,096 × 16,384 cells, 134.2 MB in bfloat16, and Σ A²·A = 4.27e9 > 2^31
PATH_P_CLIQUES = (32, 512)
PATH_P_KERNELS = ("indptr", "radix_rank", "csr_spmv")  # K3, K5, K2
PATH_P_ORIENTATIONS = {"x,y": ("x", "y"), "y,x": ("y", "x")}  # (c): a row of tiles on one process; across both
PATH_P_MTX = "rand-20k.mtx"  # (e): the experiment's file, written by the parent into the group's directory


def path_p_sizes() -> tuple:
    """Path P's sizes, which the parent passes to the group's processes
    (``--path-p-sizes``): the cliques' count and size."""
    return PATH_P_CLIQUES


def path_p_inputs(dev, seed: int, sizes: tuple, directory) -> dict:
    """Path P's own inputs, the same on every process: the cliques
    (``clique_entries`` from ``seed + 2``) as ``(row, col)``, then with each
    pair oriented by a coin, their vertex count, and the experiment's MTX
    file in ``directory``."""
    count, size = sizes
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 2)
    return {"cliques": clique_entries(g, dev, count, size), "cliques directed": clique_entries(g, dev, count, size,
                                                                                             directed=True),
            "sizes": sizes, "n": count * size, "mtx": str(Path(directory) / PATH_P_MTX)}


def write_path_p_mtx(dev, directory) -> None:
    """The suite's rand-20k as a general real MTX file in ``directory``."""
    from sparsebase_tpu_torch import IOBase, bench_suite

    IOBase.write_csr_to_mtx(bench_suite.MATRICES["rand-20k"](dev), str(Path(directory) / PATH_P_MTX))


def path_p_run(sh, src, x, inputs, mesh, mesh_2d, suite_shards: Optional[int]) -> dict:
    """Path P: (a) the dense ring on the cliques (``ring.triangle_count``,
    ``jaccard_flat``, and ``triangle_count(directed=True)`` on the oriented
    ones), each ingested by ``from_coo_sharded``; (b) the sparse ring on
    path M's container ``sh`` (``triangle_count`` and ``jaccard_flat``,
    past ``MAX_DENSE_ELEMS``); (c) ``Sharded2DCSR.from_csr`` of path M's CSR
    ``src`` on ``mesh_2d`` with its axes either way round, ``spmv`` of x and
    ``degrees``; (d) ``sh.stacked("indptr")``, ``stacked("nnz_local")``,
    ``sh.to(MeshContext(mesh))`` and ``sh.to`` the device's context; (e)
    where ``suite_shards`` is given, ``bench_suite.run_distributed`` on
    that many shards (a process, in a group), and an experiment of
    ``load_sharded_csr(mesh)``, ``distributed_reorder("rcm")`` and
    ``distributed_spmv_kernel`` on the MTX file. Returns the results by
    call."""
    from sparsebase_tpu_torch import bench_suite, experiment
    from sparsebase_tpu_torch.context import MeshContext, context_for
    from sparsebase_tpu_torch.parallel import ShardedCSR, ring, sharded2d

    dev = mesh.first_device
    n_c = inputs["n"]
    cliques, directed = (ShardedCSR.from_coo_sharded(*inputs[name], None, (n_c, n_c), mesh)
                         for name in ("cliques", "cliques directed"))
    results = {"(a) ring.triangle_count": ring.triangle_count(cliques, mesh),
               "(a) ring.jaccard_flat": ring.jaccard_flat(cliques, mesh),
               "(a) ring.triangle_count directed": ring.triangle_count(directed, mesh, directed=True)}
    del cliques, directed
    results["(b) ring.triangle_count"] = ring.triangle_count(sh, mesh)
    results["(b) ring.jaccard_flat"] = ring.jaccard_flat(sh, mesh)
    for o, axes in PATH_P_ORIENTATIONS.items():
        tiles = results[f"(c) Sharded2DCSR.from_csr {o}"] = sharded2d.Sharded2DCSR.from_csr(src, mesh_2d, axes)
        results[f"(c) sharded2d.spmv {o}"] = sharded2d.spmv(tiles, x, mesh_2d)
        results[f"(c) sharded2d.degrees {o}"] = sharded2d.degrees(tiles, mesh_2d)
    for name in ("indptr", "nnz_local"):
        results[f"(d) ShardedCSR.stacked {name}"] = sh.stacked(name)
    results["(d) ShardedCSR.to mesh"] = sh.to(MeshContext(mesh))
    results["(d) ShardedCSR.to device"] = sh.to(context_for(dev))
    if suite_shards is not None:
        results["(e) run_distributed"] = bench_suite.run_distributed(device=dev.type, shards=suite_shards)
    exp = experiment.ConcreteExperiment()
    exp.add_data_loader(experiment.load_sharded_csr(mesh), [([inputs["mtx"]], None)])
    exp.add_preprocess("rcm", experiment.distributed_reorder("rcm"))
    exp.add_kernel("spmv", experiment.distributed_spmv_kernel)
    exp.run(times=1, store_auxiliary=True)
    data = exp.get_auxiliary()[f"preprocess,rcm,{inputs['mtx']}"]
    results["(e) experiment"] = {"order": data[2], "y": exp.get_results(), "n": data[0].shape[0]}
    return results


def fingerprint(x):
    """``x`` with each tensor replaced by its dtype, shape and the SHA-256
    of its bytes (equal fingerprints: equal bit for bit), through dicts,
    tuples and lists."""
    if isinstance(x, torch.Tensor):
        raw = x.detach().contiguous().reshape(-1).cpu()
        return ("tensor", str(x.dtype), tuple(x.shape), hashlib.sha256(raw.view(torch.uint8).numpy().tobytes()
                                                                         if raw.numel() else b"").hexdigest())
    if isinstance(x, dict):
        return {k: fingerprint(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return tuple(fingerprint(v) for v in x)
    return x


def path_p_record(results):
    """Path P's results as :func:`same` compares them, every tensor as its
    :func:`fingerprint`: a ``ShardedCSR`` as its :func:`sharded_record`, a
    ``Sharded2DCSR`` as the fields of its own tiles (flat (i, j) index)
    with its counts and widths."""
    from sparsebase_tpu_torch.parallel import Sharded2DCSR, ShardedCSR

    def record(r):
        if isinstance(r, ShardedCSR):
            return sharded_record(r)
        if isinstance(r, Sharded2DCSR):
            dc = r.grid[1]
            fields = [name for name in r._FIELDS if getattr(r, name) is not None]
            return {"shards": {i * dc + j: {name: getattr(r, name)[i][j] for name in fields} for i, j in r.local},
                    "nnz_counts": r.nnz_counts, "grid": r.grid, "rows": r.rows_per_tile, "width": r.width}
        return r

    return fingerprint({name: record(r) for name, r in results.items()})


def path_p_checks(src, x, sh, mesh, inputs, res) -> float:
    """Path P's results on one process held to references that do not lean
    on the multi-shard route: (a) K6 on the whole cliques' CSR and the
    closed forms; (b) K6 on path M's CSR; (c) y against the plain SpMV of
    path M's CSR, the degrees equal to ``dist.degrees``; (d) the stacked
    fields and both moves equal to the container's fields; (e) the
    experiment's y against the plain SpMV of its file's CSR, its order a
    permutation. Returns (e)'s largest difference, K2's on whole rows ((c)
    adds each row's partial sums over the tiles in another order than the
    plain SpMV, so it is held to the bound only)."""
    from sparsebase_tpu_torch import COO, CSR, IOBase
    from sparsebase_tpu_torch.ops.feature import JaccardWeights, TriangleCount
    from sparsebase_tpu_torch.ops.kernels import csr_spmv_plain
    from sparsebase_tpu_torch.parallel import dist

    (count, size), n_c = inputs["sizes"], inputs["n"]
    csr = COO.new(*inputs["cliques"], None, (n_c, n_c)).convert(CSR)
    want = TriangleCount().get_triangle_count(csr)
    tri = res["(a) ring.triangle_count"]
    check(tri == want == count * (size * (size - 1) * (size - 2) // 6),
          f"path P (a): {tri} triangles on the cliques, K6 {want}")
    check_equal("path P (a) jaccard_flat vs K6 JaccardWeights", res["(a) ring.jaccard_flat"],
                JaccardWeights().get_jaccard_weights(csr).vals)
    directed = COO.new(*inputs["cliques directed"], None, (n_c, n_c)).convert(CSR)
    want_d = TriangleCount(True).get_triangle_count(directed)
    check(res["(a) ring.triangle_count directed"] == want_d,
          f"path P (a): directed {res['(a) ring.triangle_count directed']} against K6's {want_d}")
    del csr, directed
    print(f"phase 4 path P (a) the cliques (n={n_c}, {inputs['cliques'][0].numel()} entries): {tri} triangles and "
          f"the weights equal to K6's; directed {want_d} 3-cycles equal to K6's")
    want = TriangleCount().get_triangle_count(src)
    check(res["(b) ring.triangle_count"] == want,
          f"path P (b): {res['(b) ring.triangle_count']} triangles on path M's graph, K6 {want}")
    check_equal("path P (b) jaccard_flat vs K6 JaccardWeights", res["(b) ring.jaccard_flat"],
                JaccardWeights().get_jaccard_weights(src).vals)
    print(f"phase 4 path P (b) the sparse ring on path M's graph (n={src.nrows}, {src.nnz} entries): {want} "
          "triangles and the weights equal to K6's")
    y_ref, absdot, deg = csr_spmv_plain(src, x), csr_spmv_plain(abs_csr(src), x.abs()), src.degrees()
    deg_d = dist.degrees(sh, mesh)
    for o in PATH_P_ORIENTATIONS:
        check_rows(f"path P (c) sharded2d.spmv {o} (K2 per tile) vs plain SpMV of the whole CSR",
                   res[f"(c) sharded2d.spmv {o}"], y_ref, deg, absdot)
        check_equal(f"path P (c) sharded2d.degrees {o} vs dist.degrees", res[f"(c) sharded2d.degrees {o}"], deg_d)
    for name in ("indptr", "nnz_local"):
        check_equal(f"path P (d) stacked({name!r})", res[f"(d) ShardedCSR.stacked {name}"],
                    torch.stack(list(getattr(sh, name))))
    for label in ("mesh", "device"):
        moved = res[f"(d) ShardedCSR.to {label}"]
        check(moved.nnz_counts == sh.nnz_counts and moved._mesh is None, f"path P (d) to {label}: counts or mesh")
        for name in PATH_M_FIELDS:
            for k in range(sh.n_shards):
                check(torch.equal(getattr(moved, name)[k], getattr(sh, name)[k]),
                      f"path P (d) to {label}: shard {k}'s {name} differs")
    e = res["(e) experiment"]
    file_csr = IOBase.read_mtx_to_csr(inputs["mtx"], device=x.device)
    ones = torch.ones((file_csr.ncols,), dtype=torch.float32, device=x.device)
    (y,) = e["y"].values()
    err = check_rows("path P (e) the experiment's halo.spmv vs plain SpMV of its file", y,
                     csr_spmv_plain(file_csr, ones), file_csr.degrees(), csr_spmv_plain(abs_csr(file_csr), ones))
    check(bool((torch.bincount(e["order"].long(), minlength=file_csr.nrows) == 1).all()),
          "path P (e) the experiment's order is not a permutation")
    print(f"phase 4 path P (c), (d), (e): y of both orientations within the bound, the degrees, stacked fields and "
          f"moved shards equal; the experiment on {PATH_P_MTX} (n={file_csr.nrows}, {file_csr.nnz} entries) within "
          "the bound, its RCM order a permutation")
    return err


def path_p_group_checks(label: str, results, kids, suite) -> None:
    """Every process's path P results equal to the one process's bit for
    bit (its own shards and tiles exactly: a row of tiles with the axes
    ("x", "y"), a column with ("y", "x"); every shard after ``to`` the
    device), and its ``run_distributed`` table, but for its times, equal
    to ``suite``."""
    per = PATH_M_SHARDS // PATH_M_PROCESSES
    for kid in kids:
        rank, got = kid["rank"], kid["path_p"]["results"]
        owned = {"(c) Sharded2DCSR.from_csr x,y": tuple(range(rank * per, (rank + 1) * per)),
                 "(c) Sharded2DCSR.from_csr y,x": tuple(range(rank, PATH_M_SHARDS, PATH_M_PROCESSES)),
                 "(d) ShardedCSR.to device": tuple(range(PATH_M_SHARDS))}
        for name, want in results.items():
            check(same(got[name], want, owned.get(name, kid["local"])),
                  f"path P {label} rank {rank}: {name} differs from the single-process mesh")
        table = got["(e) run_distributed"]
        check(without_times(table) == without_times(suite),
              f"path P {label} rank {rank}: run_distributed {table} against the one process's {suite}")
    print(f"phase 4 path P {label}: {len(kids)} processes equal to the single-process mesh of {PATH_M_SHARDS} shards "
          f"bit for bit in every result: {', '.join(results)}; run_distributed equal but for its times to one "
          "process's")


def phase_group_checks(path: str, label: str, results, stats, kids) -> None:
    """Every process's results of path ``path`` (N or O: tensors with their
    dtypes, containers shard by shard, its own shards exactly) and ``stats``
    equal to the one process's bit for bit."""
    for kid in kids:
        got = kid[f"path_{path.lower()}"]
        for name, want in results.items():
            check(same(got["results"][name], want, kid["local"]),
                  f"path {path} {label} rank {kid['rank']}: {name} differs from the single-process mesh")
            check(got["stats"][name] == stats[name],
                  f"path {path} {label} rank {kid['rank']}: {name} stats {got['stats'][name]} against {stats[name]}")
    print(f"phase 4 path {path} {label}: {len(kids)} processes equal to the single-process mesh of {PATH_M_SHARDS} "
          f"shards bit for bit in every result and stats: {', '.join(results)}")


def path_m_child(out: str, n: int, seed: int, backend: str, device: str, o_sizes: tuple, p_sizes: tuple) -> None:
    """One process of path M's group (``chip_smoke.py --path-m-child DIR``,
    started by ``multihost.launch``): joins the group, runs the tool's path
    on its two shards of ``global_mesh``, path N, path O and path P (on
    ``global_mesh_2d`` too, and the experiment's file in ``DIR``), and saves
    its shards' fields, y, the order, the results and stats of paths N, O
    and P, and the launches of paths M, N, O and P to ``DIR``. It loads the
    kernels that the parent built and builds nothing."""
    import torch.distributed as tdist

    from sparsebase_tpu_torch import CSR, _build
    from sparsebase_tpu_torch.ops.kernels import indptr_plain
    from sparsebase_tpu_torch.parallel import multihost

    if device == "cuda":
        check((_build.BUILD_ROOT / _build.source_hash() / _build.LIB_NAME).exists(),
              "path M: the kernels are not built; the parent builds them before the group starts")
    check(multihost.initialize(backend=backend, timeout=PATH_M_TIME_LIMIT), "path M: no process group")
    rank = tdist.get_rank()
    dev = torch.device("cpu") if device == "cpu" else torch.device("cuda", rank if backend == "nccl" else 0)
    mesh = multihost.global_mesh(devices=[dev] * (PATH_M_SHARDS // PATH_M_PROCESSES))
    row, col, vals, x = tool_graph(dev, n, PATH_M_AVG_DEG, seed)
    _build.reset_launch_counts()
    sh, y, order, stats = path_m_run(mesh, row, col, vals, x)
    launches = _build.launch_counts()
    _build.reset_launch_counts()
    results_n, stats_n = path_n_run(sh, mesh, x)
    path_n = {"results": on_host(results_n), "stats": stats_n, "launches": _build.launch_counts()}
    del results_n
    src = CSR(indptr_plain(row, n), col, vals, (n, n))
    inputs_o = path_o_inputs(dev, mesh, seed, o_sizes)
    _build.reset_launch_counts()
    results_o, stats_o = path_o_run(sh, src, inputs_o, mesh)
    path_o = {"results": on_host(path_o_record(results_o)), "stats": stats_o, "launches": _build.launch_counts()}
    del results_o, inputs_o
    inputs_p = path_p_inputs(dev, seed, p_sizes, out)
    per = PATH_M_SHARDS // PATH_M_PROCESSES
    mesh_2d = multihost.global_mesh_2d((PATH_M_PROCESSES, per), devices=[dev] * per)
    _build.reset_launch_counts()
    results_p = path_p_run(sh, src, x, inputs_p, mesh, mesh_2d, per)
    path_p = {"results": path_p_record(results_p), "launches": _build.launch_counts()}
    del results_p, inputs_p, src
    torch.save({
        "rank": rank, "backend": tdist.get_backend(), "mesh": repr(mesh), "local": sh.local,
        "fields": {name: {k: getattr(sh, name)[k].cpu() for k in sh.local} for name in PATH_M_FIELDS},
        "nnz_counts": sh.nnz_counts, "stats": stats, "width": sh.width, "halo_width": sh.halo_width,
        "halo_bytes": sh.halo_bytes_per_exchange, "y": y.cpu(), "order": order.cpu(), "launches": launches,
        "path_n": path_n, "path_o": path_o, "path_p": path_p,
    }, Path(out) / f"rank{rank}.pt")
    tdist.barrier()
    tdist.destroy_process_group()


def path_m_group(dev, n: int, seed: int, backend: str, out: str) -> list:
    """Path M's two processes (``multihost.launch``, ``PATH_M_TIME_LIMIT``)
    in the directory ``out`` (which holds path P's MTX file): each rank's
    saved results."""
    from sparsebase_tpu_torch.parallel import multihost

    files = [Path(out) / f"rank{r}.pt" for r in range(PATH_M_PROCESSES)]
    try:
        multihost.launch([sys.executable, str(REPO / "chip_smoke.py"), "--path-m-child", out, "--path-m-n", str(n),
                          "--seed", str(seed), "--path-m-backend", backend, "--path-m-device", dev.type,
                          "--path-o-sizes", ",".join(map(str, path_o_sizes())),
                          "--path-p-sizes", ",".join(map(str, path_p_sizes()))],
                         PATH_M_PROCESSES, timeout=PATH_M_TIME_LIMIT, cwd=str(REPO))
        return [torch.load(f, weights_only=False) for f in files]
    finally:
        for f in files:
            f.unlink(missing_ok=True)


def phase_path_m_checks(label: str, sh, y, order, stats, kids) -> None:
    """Every process's shards, counts, route capacity, ``w_c``, y and order
    equal to the single-process mesh's bit for bit."""
    per = PATH_M_SHARDS // PATH_M_PROCESSES
    for r, kid in enumerate(kids):
        check(kid["local"] == tuple(range(r * per, (r + 1) * per)), f"path M {label} rank {r}: shards {kid['local']}")
        check(kid["nnz_counts"] == sh.nnz_counts, f"path M {label} rank {r}: nnz_counts {kid['nnz_counts']} "
                                                  f"against {sh.nnz_counts}")
        check(kid["stats"]["route_capacity"] == stats["route_capacity"] and
              kid["stats"]["compacted_width"] == stats["compacted_width"],
              f"path M {label} rank {r}: route {kid['stats']} against {stats}")
        check((kid["width"], kid["halo_width"], kid["halo_bytes"]) == (sh.width, sh.halo_width,
                                                                         sh.halo_bytes_per_exchange),
              f"path M {label} rank {r}: widths or halo bytes differ")
        for name in PATH_M_FIELDS:
            for k, got in kid["fields"][name].items():
                want = getattr(sh, name)[k]
                same = got.dtype == want.dtype and got.shape == want.shape and torch.equal(got.to(want.device), want)
                check(same, f"path M {label} rank {r} shard {k}: {name} differs from the single-process mesh")
        check(torch.equal(kid["y"].to(y.device), y), f"path M {label} rank {r}: y differs")
        check(torch.equal(kid["order"].to(order.device), order), f"path M {label} rank {r}: the order differs")
    print(f"phase 4 path M {label}: {len(kids)} processes x {per} shards equal to the single-process mesh of "
          f"{PATH_M_SHARDS} shards bit for bit: nnz_counts {sh.nnz_counts}, route capacity {stats['route_capacity']}, "
          f"w_c {stats['compacted_width']}, every shard's {', '.join(PATH_M_FIELDS)}, y and the RCM order")


def path_m(dev, seed: int, n: int = PATH_M_N, suite: Optional[dict] = None) -> tuple:
    """Path M's phases 3 and 4, after path L, with paths N, O and P
    inside: the tool's graph on a single-process mesh of ``PATH_M_SHARDS``
    shards of the card, then on two gloo processes that share the card with
    two shards each, every field held bit for bit; after path M's phases
    each runs path N (:func:`path_n_run`) on its container, then path O
    (:func:`path_o_run`) on it, on its CSR and on path O's own graphs, then
    path P (:func:`path_p_run`) on the cliques, on the container and its
    CSR, the suite and the experiment, every result held bit for bit (the
    processes' ``run_distributed`` tables to ``suite``, path L's, or where
    path L did not run to the one process's made here); with two or more
    cards, on two NCCL processes with a card each. Returns the launch counts of paths M, N, O and P
    (each the single-process run's and the processes') and K2's largest
    difference from the plain SpMV."""
    group_dir = tempfile.mkdtemp(prefix="path_m_")  # the group's results and path P's MTX file
    try:
        return _path_m(dev, seed, n, suite, group_dir)
    finally:
        shutil.rmtree(group_dir, ignore_errors=True)


def _path_m(dev, seed: int, n: int, suite: Optional[dict], group_dir: str) -> tuple:
    """:func:`path_m` in the group's directory ``group_dir``."""
    from sparsebase_tpu_torch import CSR, _build, bench_suite
    from sparsebase_tpu_torch.ops.kernels import csr_spmv_plain, indptr_plain
    from sparsebase_tpu_torch.parallel import make_mesh, make_mesh_2d

    row, col, vals, x = tool_graph(dev, n, PATH_M_AVG_DEG, seed)
    nnz = row.numel()
    print(f"phase 3 path M graph: tools/multiproc_dcn.py's at n={n}, average degree {PATH_M_AVG_DEG}: {nnz} entries, "
          "made on the card")
    mesh = make_mesh(devices=[dev] * PATH_M_SHARDS)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    sh, y, order, stats = path_m_run(mesh, row, col, vals, x)
    launches = read_launches(f"M, one process of {PATH_M_SHARDS} shards", ("indptr", "radix_rank", "csr_spmv"))
    _build.reset_launch_counts()
    results_n, stats_n = path_n_run(sh, mesh, x)
    launches_n = read_launches(f"N, one process of {PATH_M_SHARDS} shards", PATH_N_KERNELS)
    src = CSR(indptr_plain(row, n), col, vals, (n, n))
    inputs_o = path_o_inputs(dev, mesh, seed, path_o_sizes())
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    results_o, stats_o = path_o_run(sh, src, inputs_o, mesh)
    launches_o = read_launches(f"O, one process of {PATH_M_SHARDS} shards", PATH_O_KERNELS)
    write_path_p_mtx(dev, group_dir)
    inputs_p = path_p_inputs(dev, seed, path_p_sizes(), group_dir)
    mesh_2d = make_mesh_2d((PATH_M_PROCESSES, PATH_M_SHARDS // PATH_M_PROCESSES), devices=[dev] * PATH_M_SHARDS)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    results_p = path_p_run(sh, src, x, inputs_p, mesh, mesh_2d, None)
    launches_p = read_launches(f"P, one process of {PATH_M_SHARDS} shards", PATH_P_KERNELS)

    err = check_rows("path M halo.spmv, one process, vs plain SpMV of the whole CSR", y, csr_spmv_plain(src, x),
                     src.degrees(), csr_spmv_plain(abs_csr(src), x.abs()))
    check_equal("path M dist.rcm_reorder vs the plain (level, degree, id) rank", order,
                plain_rcm(plain_bfs_levels(src, 0), src.degrees()))
    natural, rcm = bandwidth(row, col), bandwidth(row, col, order)
    print(f"phase 4 path M RCM bandwidth {rcm} against the natural {natural}")
    err = max(err, path_n_checks(sh, mesh, src, x, results_n))
    path_o_checks(src, inputs_o, results_o)
    results_o = path_o_record(results_o)
    err = max(err, path_p_checks(src, x, sh, mesh, inputs_p, results_p))
    results_p = path_p_record(results_p)
    if suite is None:  # path L did not run: the one process's table, made here
        suite = bench_suite.run_distributed(device=dev.type, shards=PATH_M_SHARDS)
    del src, inputs_o, inputs_p
    # the group's processes share the card: give back what the earlier paths
    # left in this process's allocator cache
    torch.cuda.empty_cache()

    kids = path_m_group(dev, n, seed, "gloo", group_dir)
    phase_path_m_checks("gloo", sh, y, order, stats, kids)
    for kid in kids:
        check(kid["backend"] == "gloo", f"path M: backend {kid['backend']}")
        print(f"phase 3 path M rank {kid['rank']} ({kid['mesh']}): launches {kid['launches']}")
        require_launches(f"M, rank {kid['rank']}", kid["launches"], ("indptr", "radix_rank", "csr_spmv"))
        launches = {k: launches[k] + kid["launches"][k] for k in launches}
    phase_group_checks("N", "gloo", results_n, stats_n, kids)
    for kid in kids:
        print(f"phase 3 path N rank {kid['rank']}: launches {kid['path_n']['launches']}")
        require_launches(f"N, rank {kid['rank']}", kid["path_n"]["launches"], PATH_N_KERNELS)
        launches_n = {k: launches_n[k] + kid["path_n"]["launches"][k] for k in launches_n}
    phase_group_checks("O", "gloo", results_o, stats_o, kids)
    for kid in kids:
        print(f"phase 3 path O rank {kid['rank']}: launches {kid['path_o']['launches']}")
        require_launches(f"O, rank {kid['rank']}", kid["path_o"]["launches"], PATH_O_KERNELS)
        launches_o = {k: launches_o[k] + kid["path_o"]["launches"][k] for k in launches_o}
    path_p_group_checks("gloo", results_p, kids, suite)
    for kid in kids:
        print(f"phase 3 path P rank {kid['rank']}: launches {kid['path_p']['launches']}")
        require_launches(f"P, rank {kid['rank']}", kid["path_p"]["launches"], PATH_P_KERNELS)
        launches_p = {k: launches_p[k] + kid["path_p"]["launches"][k] for k in launches_p}

    if torch.cuda.device_count() >= PATH_M_PROCESSES:
        kids_nccl = path_m_group(dev, n, seed, "nccl", group_dir)
        phase_path_m_checks("nccl", sh, y, order, stats, kids_nccl)
        phase_group_checks("N", "nccl", results_n, stats_n, kids_nccl)
        phase_group_checks("O", "nccl", results_o, stats_o, kids_nccl)
        path_p_group_checks("nccl", results_p, kids_nccl, suite)
    else:
        print(f"phase 3 path M NCCL route: skipped, {torch.cuda.device_count()} card visible; it needs one card "
              f"a process ({PATH_M_PROCESSES}), and NCCL refuses two ranks on one card")
    return launches, launches_n, launches_o, launches_p, err


def read_launches(path: str, required) -> dict:
    from sparsebase_tpu_torch import _build

    torch.cuda.synchronize()
    counts = _build.launch_counts()
    print(f"phase 3 path {path}: launches {counts}")
    require_launches(path, counts, required)
    return counts


def require_launches(path: str, counts: dict, required) -> None:
    for name in required:
        check(counts[name] > 0, f"path {path} did not launch {name}")


PROFILE_CALLS = 3  # calls of each profiled call under torch.profiler


def phase_kernel_table(coo_a, x_a, src, ro, dia_b, x_b, csr_f) -> dict:
    """Phase 5, PERF.md's kernel table, on the inputs the checks built: each
    kernel's one call between two CUDA events (``cuda_ms``, the wrapper's
    host time included), its device time per call under ``torch.profiler``,
    its plain version, the one PyTorch call that computes the same function
    where there is one (the package never makes it) and its bound. K2–K5 at
    path A's shapes, their device times from a profile of path A's call;
    K1 on path B's band, from path B's call (its tiled layout from its own);
    K6 in Jaccard mode on path F's graph; K7's first round on path A's
    graph. Returns each row's ``ms``, ``device_ms``, ``plain_ms``,
    ``library_ms``, ``bound_ms`` and ``bound_by`` by its label (K1–K7)."""
    import sparsebase_tpu_torch as sbt
    from sparsebase_tpu_torch.ops.kernels import (
        banded_spmv, common_neighbors, common_neighbors_plain, csr_spmv, csr_spmv_plain, dia_spmv_plain,
        indptr_from_sorted_rows, indptr_plain, label_prop_round, label_prop_round_plain, radix_rank,
        radix_rank_plain, relocate_csr, relocate_csr_plain,
    )
    from sparsebase_tpu_torch.experiment import TRACE_MARGIN_S
    from sparsebase_tpu_torch.ops.partition.labelprop import _chunks

    n, nnz, dev = src.nrows, src.nnz, x_a.device
    degrees = src.degrees()
    degree_bits = nnz.bit_length()  # what path A states of its keys: a degree is at most nnz
    starts = torch.arange(n + 1, dtype=torch.int32, device=dev)  # the rows' starts, for searchsorted
    lib_name, lib_spmv = library_spmv(src, x_a)
    check_rows(f"path A {lib_name} vs plain", lib_spmv(), csr_spmv_plain(src, x_a), degrees,
               csr_spmv_plain(abs_csr(src), x_a.abs()))
    first, alpha, cap = _chunks(n, PARTITION_K, dev), 1 / PARTITION_ROUNDS, 1.1 * n / PARTITION_K
    classes = {spec["bound"]: name for name, spec in kernel_table().items()}  # kernel -> K1..K7

    def device_ms(fn):
        fn()
        # the profiler held open long enough that, in a process this old,
        # it keeps a short window's kernels (experiment.TRACE_MARGIN_S)
        trace, _ = profile_calls(fn, PROFILE_CALLS, torch.cuda.synchronize, TRACE_MARGIN_S)
        return {c: trace.kernel_s(c) / trace.calls * 1e3 for c in classes.values()}

    device = {label: device_ms(fn) for label, fn in (
        ("path A", lambda: sbt.preprocess_pipeline(coo_a, x_a)),
        ("path B", lambda: sbt.spmv(dia_b, x_b)),
        ("K1 tiled", lambda: banded_spmv(dia_b, x_b, layout="tiled")),
        ("K6", lambda: common_neighbors(csr_f, "jaccard")),
        ("K7", lambda: label_prop_round(src, first, PARTITION_K, alpha, cap)))}
    band = dict(ndiag=dia_b.num_diagonals, n=dia_b.shape[0], m=dia_b.shape[1], band_bytes=dia_b.data.element_size())
    rows = (  # (label, kernel, call, plain version, (library call's name, call), profile, the bound's shapes)
        ("K1", "banded_spmv", lambda: banded_spmv(dia_b, x_b),
         lambda: dia_spmv_plain(dia_b.offsets, dia_b.data, x_b, dia_b.shape), None, "path B", band),
        ("K1 tiled", "banded_spmv", lambda: banded_spmv(dia_b, x_b, layout="tiled"), None, None, "K1 tiled", band),
        ("K2", "csr_spmv", lambda: csr_spmv(src, x_a), lambda: csr_spmv_plain(src, x_a), (lib_name, lib_spmv),
         "path A", dict(n=n, ncols=n, nnz=nnz)),
        ("K3", "indptr", lambda: indptr_from_sorted_rows(coo_a.row, n), lambda: indptr_plain(coo_a.row, n),
         ("torch.searchsorted", lambda: torch.searchsorted(coo_a.row, starts)), "path A", dict(nnz=nnz, nrows=n)),
        ("K4", "relocate_csr", lambda: relocate_csr(src, ro, ro), lambda: relocate_csr_plain(src, ro, ro), None,
         "path A", dict(n=n, nnz=nnz, order_entries=n, value_bytes=4)),  # ro is both orders
        ("K5", "radix_rank", lambda: radix_rank(degrees, degree_bits), lambda: radix_rank_plain(degrees),
         ("torch.argsort(stable=True)", lambda: torch.argsort(degrees, stable=True)), "path A",
         dict(n=n, key_bytes=degrees.element_size())),
        ("K6", "common_neighbors", lambda: common_neighbors(csr_f, "jaccard"),
         lambda: common_neighbors_plain(csr_f, "jaccard"), None, "K6", dict(n=csr_f.nrows, nnz=csr_f.nnz)),
        ("K7", "label_prop", lambda: label_prop_round(src, first, PARTITION_K, alpha, cap),
         lambda: label_prop_round_plain(src, first, PARTITION_K, alpha, cap), None, "K7", dict(n=n, nnz=nnz)),
    )
    table = {}
    for label, kernel, call, plain, library, profile, shapes in rows:
        ms = cuda_ms(call)
        device_ms = device[profile][classes[kernel]] or None  # None: the profiler kept none of its kernels
        plain_ms = None if plain is None else cuda_ms(plain, reps=3)
        library_ms = None if library is None else cuda_ms(library[1])
        if kernel == "common_neighbors":  # integer compares: the bytes bound it
            bound_ms, bound_by = common_neighbors_bytes(**shapes) / HBM_BYTES_PER_S * 1e3, "bytes"
        else:
            bound_s, bound_by = bound(kernel, **shapes)
            bound_ms = bound_s * 1e3
        print(f"phase 5 {label} {kernel}: one call {ms:.4f} ms, device "
              + ("not measured" if device_ms is None else f"{device_ms:.4f} ms")
              + ("" if plain_ms is None else f", plain {plain_ms:.4f} ms")
              + ("" if library is None else f", {library[0]} {library_ms:.4f} ms")
              + f"; bound {bound_ms:.4f} ms ({bound_by}): "
              + ("" if device_ms is None else f"{bound_ms / device_ms:.1%} of the device time, ")
              + f"{bound_ms / ms:.1%} of the call")
        table[label] = dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                            bound_by=bound_by)
    streamed = streamed_bytes(csr_f, "jaccard")
    print(f"  K6, a diagnostic beside the bound: its stream direction reads {streamed} bytes in Jaccard mode (N(v) "
          f"and the indptr pair of every entry), {streamed / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s")
    return table


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nnz", type=float, default=100e6, help="path A and C entries (default 100M)")
    ap.add_argument("--band-nnz", type=float, default=64e6, help="path B stored band entries (default 64M)")
    # 131,072 until path N joined the script: 65,536 halves path D's level
    # steps, one host read each, to keep the script within its 700 s budget
    ap.add_argument("--rcm-n", type=int, default=65_536, help="path D rows of the scrambled band (default 65,536)")
    ap.add_argument("--ingest-nnz", type=float, default=32e6,
                    help="path E and I source entries, written as a symmetric MTX file (default 32M, n = nnz/16)")
    ap.add_argument("--feature-n", type=int, default=4_000_000,
                    help="path F vertices, average degree 16 (default 4,000,000: about 68M entries)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--path-m-child", metavar="DIR", help=argparse.SUPPRESS)  # one process of path M's group
    ap.add_argument("--path-m-n", type=int, default=PATH_M_N, help=argparse.SUPPRESS)
    ap.add_argument("--path-m-backend", default="gloo", help=argparse.SUPPRESS)
    ap.add_argument("--path-m-device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--path-o-sizes", default=",".join(map(str, path_o_sizes())), help=argparse.SUPPRESS)
    ap.add_argument("--path-p-sizes", default=",".join(map(str, path_p_sizes())), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.path_m_child:
        path_m_child(args.path_m_child, args.path_m_n, args.seed, args.path_m_backend, args.path_m_device,
                     tuple(int(v) for v in args.path_o_sizes.split(",")),
                     tuple(int(v) for v in args.path_p_sizes.split(",")))
        return

    dev = phase_device()
    import sparsebase_tpu_torch as sbt
    from sparsebase_tpu_torch import CSR, DIA, _build
    from sparsebase_tpu_torch.ops.kernels import (
        csr_spmv, csr_spmv_plain, dia_spmv_plain, indptr_from_sorted_rows, indptr_plain, radix_argsort, radix_rank,
        radix_rank_plain, relocate_csr_plain,
    )
    from sparsebase_tpu_torch.ops.permute import permute_2d
    from sparsebase_tpu_torch.ops.reorder import DegreeReorder

    phase_build()
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)
    phase_k7_vs_plain(g, dev, args.seed)

    # -- the slice's paths, each once -------------------------------------------
    nnz = int(args.nnz)
    n = max(nnz // 16, 1)
    coo_a = power_law_coo(g, dev, n, nnz)
    x_a = torch.randn((n,), generator=g, device=dev)
    coo_b = banded_coo(g, dev, int(args.band_nnz))
    x_b = torch.randn((coo_b.ncols,), generator=g, device=dev)
    co_c = torch.randperm(n, generator=g, device=dev).to(torch.int32)
    x_c = torch.empty_like(x_a)
    x_c[co_c] = x_a  # x in the permuted column space
    torch.cuda.synchronize()

    a_needs = ("indptr", "radix_rank", "relocate_csr", "csr_spmv")
    _build.reset_launch_counts()
    permuted, y_a = sbt.preprocess_pipeline(coo_a, x_a)
    launches_a = read_launches("A", a_needs)
    _build.reset_launch_counts()
    csr_b = coo_b.convert(CSR)
    dia_b = csr_b.convert(DIA)
    y_b = sbt.spmv(dia_b, x_b)
    launches_b = read_launches("B", ("indptr", "banded_spmv"))
    _build.reset_launch_counts()
    csr_c = coo_a.convert(CSR)
    ro_c = DegreeReorder(ascending=False).get_reorder(csr_c)
    both_c, rows_c = permute_2d(csr_c, ro_c, co_c), permute_2d(csr_c, ro_c, None)
    y_c = sbt.spmv(both_c, x_c)
    launches_c = read_launches("C", a_needs)

    # -- checks ---------------------------------------------------------------------
    print(f"phase 4 path A checks: n={n} nnz={nnz}")
    src_indptr = indptr_plain(coo_a.row, n)
    k3_out = indptr_from_sorted_rows(coo_a.row, n)
    check_equal("path A K3 indptr vs plain", k3_out, src_indptr)
    src = CSR(src_indptr, coo_a.col, coo_a.vals, coo_a.shape)
    ip = permuted.indptr
    check(ip.shape == (n + 1,) and int(ip[0]) == 0 and int(ip[-1]) == nnz, "permuted indptr ends")
    check(bool((ip[1:] >= ip[:-1]).all()), "permuted indptr is not monotone")
    check(permuted.is_sorted(), "permuted columns are not sorted within rows")
    check(bool((permuted.degrees()[1:] >= permuted.degrees()[:-1]).all()), "rows are not in ascending degree order")
    ro = radix_rank_plain(src.degrees())
    check_equal("path A K5 degree rank vs plain", DegreeReorder().get_reorder(src), ro)
    degree_bits = nnz.bit_length()  # what path A states of its keys: a degree is at most nnz
    k5_syncs = count_host_syncs(lambda: radix_rank(src.degrees(), degree_bits))
    k5_argsort_syncs = count_host_syncs(lambda: radix_argsort(src.degrees(), return_keys=True))
    check(k5_syncs == 0 and k5_argsort_syncs == 0,
          f"K5 synced the host: radix_rank {k5_syncs} times, radix_argsort {k5_argsort_syncs} times")
    check(bool((torch.bincount(ro.long(), minlength=n) == 1).all()), "ro is not a permutation")
    plain_perm = relocate_csr_plain(src, ro, ro)
    check_csr_equal("path A permuted CSR vs plain _permute_csr", permuted, plain_perm)
    x_new = torch.empty_like(x_a)
    x_new[ro] = x_a
    check_rows("path A y vs plain SpMV of the permuted matrix", y_a, csr_spmv_plain(permuted, x_new),
               permuted.degrees(), csr_spmv_plain(abs_csr(permuted), x_new.abs()))

    print(f"phase 4 path B checks: n={coo_b.nrows} band entries={coo_b.nnz} diagonals={dia_b.num_diagonals}")
    check(dia_b.num_diagonals == 2 * BAND_HALF_WIDTH + 1, "DIA has the wrong number of diagonals")
    check_equal("path B K3 indptr vs plain", csr_b.indptr, indptr_plain(coo_b.row, coo_b.nrows))
    absdot_b = dia_spmv_plain(dia_b.offsets, dia_b.data.abs(), x_b.abs(), dia_b.shape)
    deg_b = dia_row_degrees(dia_b)
    y_b_csr = sbt.spmv(csr_b, x_b)
    check_rows("path B K1 vs K2", y_b, y_b_csr, deg_b, absdot_b)
    err_k1 = check_rows("path B K1 vs plain", y_b, dia_spmv_plain(dia_b.offsets, dia_b.data, x_b, dia_b.shape),
                        deg_b, absdot_b)
    check_rows("path B K2 vs plain", y_b_csr, csr_spmv_plain(csr_b, x_b), deg_b, absdot_b)
    y_src, absdot_src = csr_spmv_plain(src, x_a), csr_spmv_plain(abs_csr(src), x_a.abs())
    y_k2 = csr_spmv(src, x_a)
    err_k2 = check_rows("path A K2 vs plain (source CSR)", y_k2, y_src, src.degrees(), absdot_src)
    check(torch.equal(y_k2, csr_spmv(src, x_a)), "path A K2: two runs differ")

    print("phase 4 path C checks")
    check_equal("path C indptr vs plain", csr_c.indptr, src_indptr)
    ro_c_plain = radix_rank_plain(-src.degrees())
    check_equal("path C K5 descending degree rank vs plain", ro_c, ro_c_plain)
    check(bool((rows_c.degrees()[1:] <= rows_c.degrees()[:-1]).all()), "path C rows are not in descending degree order")
    check_csr_equal("path C permute_2d(csr, ro, co) vs plain", both_c, relocate_csr_plain(src, ro_c, co_c))
    check_csr_equal("path C permute_2d(csr, ro, None) vs plain", rows_c, relocate_csr_plain(src, ro_c, None))
    y_ref, absdot_c = torch.empty_like(y_src), torch.empty_like(absdot_src)
    y_ref[ro_c] = y_src  # row ro[i] of the permuted product is row i of A @ x
    absdot_c[ro_c] = absdot_src
    check_rows("path C y vs plain SpMV of the source", y_c, y_ref, both_c.degrees(), absdot_c)

    # the integer kernels' largest difference from their plain versions, at
    # the main path's shapes (the checks above already require 0)
    def max_diff(a, b):
        return float((a.to(torch.float64) - b.to(torch.float64)).abs().max()) if a.numel() else 0.0

    err_k3 = max_diff(k3_out, src_indptr)
    err_k4 = max(max_diff(permuted.indices, plain_perm.indices), max_diff(permuted.vals, plain_perm.vals))
    err_k5 = max_diff(ro_c, ro_c_plain)
    del k3_out, plain_perm, csr_c, both_c, rows_c, y_c, y_ref, absdot_c, y_b_csr, absdot_b, y_k2, y_src, absdot_src
    torch.cuda.synchronize()

    phase_pair_sort(g, coo_a)
    phase_long_rows(g, dev)
    launches_d, err_k1_d = path_d(g, dev, args.rcm_n, args.seed)
    launches_e = path_e(g, dev, int(args.ingest_nnz))
    launches_f, err_k6, csr_f = path_f(g, dev, args.feature_n)
    launches_g, host_graph = path_g(g, dev, coo_a)
    n_p = n - n % PARTITION_K  # equal blocks
    coo_p, planted = planted_coo(g, dev, n_p, nnz)
    x_p = torch.randn((n_p,), generator=g, device=dev)
    launches_h, err_k7 = path_h(coo_a, x_a, host_graph, (coo_p, x_p, planted))
    del coo_p, x_p, planted
    launches_i, err_k2_i = path_i(g, dev, int(args.ingest_nnz))
    launches_j, err_k2_j, path_j_state = path_j(g, dev, coo_a, src, x_a, host_graph)
    # the 8-block graph: a quarter of path A's entries before mirroring
    # (half until path O ran inside path M's group, to keep the script
    # within its 700 s budget)
    launches_k = path_k(g, dev, path_j_state, n_p, src.nnz // 4, coo_b.nrows)
    del path_j_state
    launches_l, suite = path_l(g, dev)
    launches_m, launches_n, launches_o, launches_p, err_k2_m = path_m(dev, args.seed, suite=suite)
    by_path = {"A": launches_a, "B": launches_b, "C": launches_c, "D": launches_d, "E": launches_e, "F": launches_f,
               "G": launches_g, "H": launches_h, "I": launches_i, "J": launches_j, "K": launches_k, "L": launches_l,
               "M": launches_m, "N": launches_n, "O": launches_o, "P": launches_p}
    launches = {k: sum(counts[k] for counts in by_path.values()) for k in launches_a}

    table = phase_kernel_table(coo_a, x_a, src, ro, dia_b, x_b, csr_f)
    kernels = (  # (name, table row, source, the TPU kernel or XLA code it replaces, largest difference)
        ("banded_spmv", "K1", "banded_spmv.cu", "sparsebase_tpu/ops/kernels/banded_spmv.py:67", max(err_k1, err_k1_d)),
        ("csr_spmv", "K2", "csr_spmv.cu", "sparsebase_tpu/models/pipelines.py:189",
         max(err_k2, err_k2_i, err_k2_j, err_k2_m)),
        ("indptr", "K3", "indptr.cu", "tools/pallas_attempts.py:218", err_k3),
        ("relocate_csr", "K4", "relocate.cu", "tools/pallas_attempts.py:83", err_k4),
        ("radix_rank", "K5", "radix_sort.cu", "tools/pallas_attempts.py:109", err_k5),
        ("common_neighbors", "K6", "common_neighbors.cu", "sparsebase_tpu/ops/feature/sparse_common.py:53", err_k6),
        ("label_prop", "K7", "label_prop.cu", "sparsebase_tpu/ops/partition/labelprop.py:160", err_k7),
    )
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": f"sparsebase_tpu_torch/csrc/{source}", "replaces": replaces,
         "launches": launches[name], "launches_by_path": {p: counts[name] for p, counts in by_path.items()},
         "max_abs_err": err, **table[row]}
        for name, row, source, replaces, err in kernels]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
