"""Port parity for partitioning (``ops/partition/{base,multilevel,labelprop,
hypergraph}.py``), K7's plain version and ``models.partition_pipeline``, on
the CPU.

Every partitioner must equal the JAX package exactly on the same input, with
graphkit on and off in both packages where the route depends on it. The
label-propagation rounds are held to both JAX routes: with
``stop_when_stable`` to the numpy route (which stops at the first round that
changes nothing), without it to the jnp route called eagerly (which runs
every round). Under ``jax.jit`` XLA turns the penalty's division by a
constant into a multiply by its reciprocal, which rounds differently, so
the jitted pipeline is held to validity only. ``y`` of the pipeline is held
to the JAX package's cumsum bound (ROADMAP §3). Inputs are numpy arrays
from a seed; every JAX call runs on the CPU.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import sparsebase_tpu as ref  # noqa: E402
from sparsebase_tpu.models.pipelines import partition_pipeline as ref_partition_pipeline  # noqa: E402
from sparsebase_tpu.ops import partition as ref_partition  # noqa: E402
from sparsebase_tpu.ops.partition import hypergraph as ref_hypergraph  # noqa: E402
from sparsebase_tpu.ops.partition import labelprop as ref_labelprop  # noqa: E402
from sparsebase_tpu.ops.partition import multilevel as ref_multilevel  # noqa: E402

import fixture as fx  # noqa: E402
import sparsebase_tpu_torch as sbt  # noqa: E402
from sparsebase_tpu_torch import COO, CSR, get_config, set_config  # noqa: E402
from sparsebase_tpu_torch.models import partition_pipeline  # noqa: E402
from sparsebase_tpu_torch.ops import partition  # noqa: E402
from sparsebase_tpu_torch.ops.kernels import label_prop_round, label_prop_round_plain  # noqa: E402
from sparsebase_tpu_torch.ops.kernels.label_prop import neighbor_counts, part_counts, penalty_plain  # noqa: E402
from sparsebase_tpu_torch.ops.partition import hypergraph, labelprop, multilevel  # noqa: E402
from sparsebase_tpu_torch.utils.exceptions import TypeMismatchError  # noqa: E402


@pytest.fixture
def saved_config():
    """Both packages' settings, restored after the test."""
    saved, ref_saved = get_config(), ref.get_config()
    yield
    set_config(**{f: getattr(saved, f) for f in saved.__dataclass_fields__})
    ref.set_config(**{f: getattr(ref_saved, f) for f in ref_saved.__dataclass_fields__})


def use_graphkit(on: bool) -> None:
    set_config(use_graphkit=on)
    ref.set_config(use_graphkit=on)


# -- graphs, made with numpy from a seed ---------------------------------------
def csr_arrays(row, col, n, vals=None, dedup=True):
    """``(indptr, indices, vals)`` of the row-major-sorted entries."""
    row, col = np.asarray(row, np.int64), np.asarray(col, np.int64)
    if dedup:
        keys, first = np.unique(row * n + col, return_index=True)
        row, col = keys // n, keys % n
        vals = None if vals is None else np.asarray(vals)[first]
    order = np.lexsort((col, row))
    indptr = np.concatenate([[0], np.cumsum(np.bincount(row, minlength=n))]).astype(np.int64)
    return indptr, col[order].astype(np.int32), None if vals is None else np.asarray(vals)[order]


def grid_pairs(side):
    v = np.arange(side * side).reshape(side, side)
    r = np.r_[v[:, :-1].ravel(), v[:-1, :].ravel()]
    c = np.r_[v[:, 1:].ravel(), v[1:, :].ravel()]
    return np.r_[r, c], np.r_[c, r]


def random_pairs(seed, n, pairs, symmetric=True, empty=()):
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, pairs), rng.integers(0, n, pairs)
    if symmetric:
        r, c = np.r_[r, c], np.r_[c, r]
    keep = (r != c) & ~np.isin(r, empty) & ~np.isin(c, empty)
    return r[keep], c[keep]


def weighted(seed, n, pairs):
    """A symmetric pattern with integer-valued float32 weights 1..4."""
    r, c = random_pairs(seed, n, pairs)
    w = np.random.default_rng(seed + 100).integers(1, 5, r.size).astype(np.float32)
    return r, c, w


# name -> (indptr, indices, vals, n)
GRAPHS = {
    "fixture": lambda: (fx.ROW_PTR.astype(np.int64), fx.COLS.copy(), fx.VALS.copy(), fx.N),
    "grid-12": lambda: (*csr_arrays(*grid_pairs(12), 144), 144),
    "random-200": lambda: (*csr_arrays(*random_pairs(0, 200, 700), 200), 200),
    "directed-150": lambda: (*csr_arrays(*random_pairs(1, 150, 600, symmetric=False), 150), 150),
    "empty-rows-120": lambda: (*csr_arrays(*random_pairs(2, 120, 400, empty=(0, 7, 8, 60, 119)), 120), 120),
    "weighted-150": lambda: (*csr_arrays(*weighted(3, 150, 500)[:2], 150, weighted(3, 150, 500)[2]), 150),
}


def graph(name):
    indptr, indices, vals, n = GRAPHS[name]()
    port = CSR(torch.from_numpy(indptr), torch.from_numpy(indices),
               None if vals is None else torch.from_numpy(vals), (n, n))
    return port, ref.CSR(indptr, indices, vals, (n, n))


def assert_labels(got: torch.Tensor, want, n: int, k: int) -> None:
    assert got.dtype == torch.int32 and got.device.type == "cpu" and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if n:
        assert 0 <= int(got.min()) and int(got.max()) < k


# -- the partitioners against the JAX package -----------------------------------------
PARTITIONER_CASES = {  # name -> (class name, parameters, depends on graphkit)
    "metis-k2": ("MetisPartition", dict(num_partitions=2, seed=0), True),
    "metis-k4-seed1": ("MetisPartition", dict(num_partitions=4, seed=1), True),
    "metis-k3-niter4-ufactor100": ("MetisPartition", dict(num_partitions=3, niter=4, ufactor=100), True),
    "metis-rb-k4": ("MetisPartition", dict(num_partitions=4, ptype="rb", seed=0), False),
    "metis-rb-k5": ("MetisPartition", dict(num_partitions=5, ptype="rb", seed=2), False),
    "pulp-k2": ("PulpPartition", dict(num_partitions=2), True),
    "pulp-k4-seed3": ("PulpPartition", dict(num_partitions=4, seed=3), True),
    "pulp-k3-chunks": ("PulpPartition", dict(num_partitions=3, do_bfs_init=False), True),
    "pulp-k8-iters5-balance1.3": ("PulpPartition", dict(num_partitions=8, num_iterations=5, vert_balance=1.3), True),
    "pulp-k4-edge-balance": ("PulpPartition", dict(num_partitions=4, do_edge_balance=True), True),
    "patoh-k2": ("PatohPartition", dict(num_partitions=2), False),
    "patoh-k4": ("PatohPartition", dict(num_partitions=4), False),
    "patoh-k8-refine3-imbalance0.2": ("PatohPartition", dict(num_partitions=8, refine_rounds=3,
                                                             final_imbalance=0.2), False),
}


def partitioner_params():
    for case, (_, _, gk) in sorted(PARTITIONER_CASES.items()):
        for on in ((True, False) if gk else (True,)):
            yield pytest.param(case, on, id=f"{case}-{'graphkit' if on else 'numpy'}")


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("case,graphkit", list(partitioner_params()))
def test_partitioner_equals_jax(name, case, graphkit, saved_config):
    cls, params, _ = PARTITIONER_CASES[case]
    use_graphkit(graphkit)
    port, rcsr = graph(name)
    want = getattr(ref_partition, cls)(**params).partition(rcsr)
    got = getattr(partition, cls)(**params).partition(port)
    assert_labels(got, want, port.nrows, params["num_partitions"])


@pytest.mark.parametrize("graphkit", [True, False], ids=["graphkit", "numpy"])
@pytest.mark.parametrize("cls", ["MetisPartition", "PulpPartition", "PatohPartition"])
def test_partitioner_of_one_part_and_of_a_coo(cls, graphkit, saved_config):
    """k = 1 gives all zeros; a COO converts to CSR first (auto-convert)."""
    use_graphkit(graphkit)
    port, rcsr = graph("random-200")
    got = getattr(partition, cls)(num_partitions=1).partition(port)
    assert got.dtype == torch.int32 and not bool(got.any()) and got.shape == (200,)
    coo = COO(port.row_of_nnz(), port.indices, None, port.shape)
    want = getattr(ref_partition, cls)(num_partitions=3).partition(rcsr)
    assert_labels(getattr(partition, cls)(num_partitions=3).partition(coo), want, 200, 3)


def test_partitioner_names_and_params_match_jax():
    assert partition.__all__ == ref_partition.__all__
    for name in ("MetisPartitionParams", "PulpPartitionParams", "PatohPartitionParams"):
        port_fields = [(f.name, f.default) for f in getattr(partition, name).__dataclass_fields__.values()]
        ref_fields = [(f.name, f.default) for f in getattr(ref_partition, name).__dataclass_fields__.values()]
        assert port_fields == ref_fields
    assert len(partition.MetisPartitionParams.__dataclass_fields__) == 17
    assert isinstance(partition.MetisPartition(), partition.Partitioner)


# -- the multilevel helpers ------------------------------------------------------------
@pytest.mark.parametrize("name", ["grid-12", "random-200", "weighted-150"])
def test_matching_and_contraction_equal_jax(name):
    indptr, indices, vals, n = GRAPHS[name]()
    ew = np.ones(indices.size) if vals is None else np.abs(vals).astype(np.float64)
    sip, six, sew = multilevel._symmetrize(indptr.astype(np.int64), indices.astype(np.int64), ew, n)
    vw = np.ones(n)
    got = multilevel._heavy_edge_matching(sip, six, sew, vw, np.random.default_rng(5), 4.0)
    want = ref_multilevel._heavy_edge_matching(sip, six, sew, vw, np.random.default_rng(5), 4.0)
    np.testing.assert_array_equal(got, want)
    for a, b in zip(multilevel._contract(sip, six, sew, vw, got), ref_multilevel._contract(sip, six, sew, vw, want)):
        np.testing.assert_array_equal(a, b)


# -- label propagation: seeds, counts, penalty, rounds ----------------------------------
@pytest.mark.parametrize("k,seed", [(2, 0), (3, 7), (4, 3), (8, 11), (16, 5), (300, 1)])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_bfs_seed_equals_both_jax_routes(name, k, seed):
    port, rcsr = graph(name)
    got = labelprop._bfs_seed(port, k, seed)
    np.testing.assert_array_equal(got.numpy(), ref_labelprop._bfs_seed(np, rcsr, k, seed))
    rdev = ref.CSR(jnp.asarray(rcsr.indptr), jnp.asarray(rcsr.indices), None, rcsr.shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_labelprop._bfs_seed(jnp, rdev, k, seed)))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_neighbor_counts_equal_jax(name):
    port, rcsr = graph(name)
    n = port.nrows
    labels = np.random.default_rng(4).integers(0, 5, n).astype(np.int32)
    w = None if rcsr.vals is None else rcsr.vals
    want = ref_labelprop._neighbor_counts(np, rcsr, labels, 5, w)
    got = labelprop._neighbor_counts(port, torch.from_numpy(labels), 5, port.vals)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def penalty_cases(k):
    """50 draws of counts, labels, a capacity and a round, at 300 rows (one
    shape per ``k``: eager JAX compiles once per shape)."""
    rng = np.random.default_rng(17 + k)
    n = 300
    for _ in range(50):
        counts = rng.integers(0, int(rng.integers(1, 60)), (n, k)).astype(np.float32)
        labels = rng.integers(0, k, n).astype(np.int32)
        labels[: int(rng.integers(0, n))] = 0
        cap = float(rng.choice([rng.uniform(0.5, 2.0), rng.uniform(1, n) / k * 1.1, 1.1 * n / k]))
        iters = int(rng.integers(1, 25))
        yield counts, labels, cap, (int(rng.integers(0, iters)) + 1) / iters


@pytest.mark.parametrize("k", [2, 3, 8, 11])
def test_penalty_equals_eager_jax_bit_for_bit(k):
    """``alpha * max(sizes - cap, 0) * (max + 1) / max(cap, 1)`` as the JAX
    package's rounds compute it (``labelprop.py:172``), eagerly in jnp and in
    numpy, against the port's 0-d-tensor form."""
    for counts, labels, cap, alpha in penalty_cases(k):
        got = penalty_plain(torch.from_numpy(counts), part_counts(torch.from_numpy(labels), k), alpha, cap).numpy()
        jc, jl = jnp.asarray(counts), jnp.asarray(labels)
        sizes = jnp.bincount(jl, length=k).astype(jnp.float32)
        want = alpha * jnp.maximum(sizes - cap, 0.0) * (jc.max() + 1.0) / max(cap, 1.0)
        np.testing.assert_array_equal(got, np.asarray(want))
        sizes = np.bincount(labels, minlength=k)[:k].astype(np.float32)
        want = alpha * np.maximum(sizes - cap, 0.0) * (counts.max() + 1.0) / max(cap, 1.0)
        np.testing.assert_array_equal(got, want)


# (k, rounds, weighted, vertex balance)
PROPAGATE_CASES = [(2, 5, False, 1.1), (4, 10, False, 1.1), (8, 20, False, 1.1), (3, 7, True, 1.2),
                   (8, 10, False, 1.0), (5, 1, False, 1.5)]


@pytest.mark.parametrize("case", range(len(PROPAGATE_CASES)))
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_propagate_equals_both_jax_routes(name, case):
    """``stop_when_stable=True`` is the JAX numpy route; ``False`` the jnp
    route, called eagerly (not under jit: see the module's docstring)."""
    k, rounds, weighted_, balance = PROPAGATE_CASES[case]
    port, rcsr = graph(name)
    n = port.nrows
    cap = balance * n / k
    labels = np.asarray(ref_labelprop._bfs_seed(np, rcsr, k, case)).astype(np.int32)
    w_np = rcsr.vals if weighted_ and rcsr.vals is not None else None
    w = None if w_np is None else port.vals
    want_np = ref_labelprop._propagate(np, rcsr, labels, k, cap, w_np, rounds)
    got = labelprop._propagate(port, torch.from_numpy(labels), k, cap, w, rounds, stop_when_stable=True)
    np.testing.assert_array_equal(got.numpy(), want_np)
    rdev = ref.CSR(jnp.asarray(rcsr.indptr), jnp.asarray(rcsr.indices),
                   None if rcsr.vals is None else jnp.asarray(rcsr.vals), rcsr.shape)
    want_jnp = ref_labelprop._propagate(jnp, rdev, jnp.asarray(labels), k, cap,
                                        None if w_np is None else rdev.vals, rounds)
    got = labelprop._propagate(port, torch.from_numpy(labels), k, cap, w, rounds, stop_when_stable=False)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_jnp))


def test_weighted_round_sums_in_entry_order():
    """Real weights: the plain round's counts are sums in entry order, equal
    to ``np.add.at``'s bit for bit (the kernel sums each cell in that order
    too)."""
    rng = np.random.default_rng(8)
    n = 300
    indptr, indices, _ = csr_arrays(*random_pairs(9, n, 2_000), n)
    vals = (rng.random(indices.size) * 3).astype(np.float32)
    port = CSR(torch.from_numpy(indptr), torch.from_numpy(indices), torch.from_numpy(vals), (n, n))
    rcsr = ref.CSR(indptr, indices, vals, (n, n))
    labels = rng.integers(0, 6, n).astype(np.int32)
    np.testing.assert_array_equal(labelprop._neighbor_counts(port, torch.from_numpy(labels), 6, port.vals).numpy(),
                                  ref_labelprop._neighbor_counts(np, rcsr, labels, 6, vals))
    got = labelprop._propagate(port, torch.from_numpy(labels), 6, 1.1 * n / 6, port.vals, 8, stop_when_stable=True)
    np.testing.assert_array_equal(got.numpy(), ref_labelprop._propagate(np, rcsr, labels, 6, 1.1 * n / 6, vals, 8))


def test_weighted_counts_sum_in_entry_order_on_many_threads():
    """The plain counts add each cell's weights in entry order however many
    threads torch runs (an accumulating ``index_put_`` splits the entries
    among threads at this size), equal to ``np.add.at`` bit for bit."""
    rng = np.random.default_rng(12)
    n, k, nnz = 300, 200, 75_000
    indptr = np.concatenate([[0], np.cumsum(np.full(n, nnz // n))]).astype(np.int64)
    indices = rng.integers(0, n, nnz).astype(np.int32)
    vals = (rng.random(nnz) * 3).astype(np.float32)
    labels = rng.integers(0, k, n).astype(np.int32)
    port = CSR(torch.from_numpy(indptr), torch.from_numpy(indices), torch.from_numpy(vals), (n, n))
    want = ref_labelprop._neighbor_counts(np, ref.CSR(indptr, indices, vals, (n, n)), labels, k, vals)
    threads = torch.get_num_threads()
    torch.set_num_threads(8)
    try:
        got = labelprop._neighbor_counts(port, torch.from_numpy(labels), k, port.vals)
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_array_equal(got.numpy(), want)


def planted_graph(seed, n, k, avg_deg=16, inside=0.95):
    """A directed graph with ``k`` planted blocks of ``n / k`` vertices
    (``chip_smoke.planted_coo``'s model, with numpy): rows uniform, a
    column in its row's block with probability ``inside``, else uniform in
    another block; ids shuffled; row-major sorted, duplicates kept."""
    rng = np.random.default_rng(seed)
    size, nnz = n // k, n * avg_deg
    row = rng.integers(0, n, nnz)
    block = np.where(rng.random(nnz) < inside, row // size, (row // size + rng.integers(1, k, nnz)) % k)
    col = block * size + rng.integers(0, size, nnz)
    perm = rng.permutation(n)
    row, col = perm[row], perm[col]
    order = np.lexsort((col, row))
    indptr = np.concatenate([[0], np.cumsum(np.bincount(row, minlength=n))]).astype(np.int64)
    return indptr, col[order].astype(np.int32), row[order].astype(np.int32)


@pytest.mark.parametrize("k", [4, 8])
def test_propagate_on_a_planted_graph_equals_both_jax_routes(k):
    """From contiguous chunks (which the shuffled ids make uninformative),
    ten rounds on a planted graph move the labels; both of ``_propagate``'s
    routes equal the JAX package's (numpy; jnp called eagerly)."""
    n = 2_000
    indptr, indices, _ = planted_graph(20 + k, n, k)
    port = CSR(torch.from_numpy(indptr), torch.from_numpy(indices), None, (n, n))
    cap = 1.1 * n / k
    chunks = labelprop._chunks(n, k, torch.device("cpu"))
    got = labelprop._propagate(port, chunks, k, cap, None, 10, stop_when_stable=False)
    rdev = ref.CSR(jnp.asarray(indptr), jnp.asarray(indices), None, (n, n))
    want = ref_labelprop._propagate(jnp, rdev, jnp.asarray(chunks.numpy()), k, cap, None, 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    moved = int((got != chunks).sum())
    assert moved > n // 4 and len(np.unique(got.numpy())) > 1, moved
    got = labelprop._propagate(port, chunks, k, cap, None, 10, stop_when_stable=True)
    want = ref_labelprop._propagate(np, ref.CSR(indptr, indices, None, (n, n)), chunks.numpy(), k, cap, None, 10)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["random-200", "directed-150", "empty-rows-120"])
def test_balance_fixup_equals_jax(name):
    port, rcsr = graph(name)
    labels = np.random.default_rng(2).integers(0, 4, port.nrows).astype(np.int32)
    labels[: port.nrows // 2] = 1  # over the cap
    cap = 1.1 * port.nrows / 4
    got = labelprop._balance_fixup(port, torch.from_numpy(labels), 4, cap)
    want = ref_labelprop._balance_fixup(np, rcsr, labels.copy(), 4, cap, None)
    np.testing.assert_array_equal(got, want)
    assert np.bincount(got, minlength=4).max() <= int(np.floor(cap))


def test_label_prop_round_edge_cases():
    """Rows with no entries keep their label; labels outside [0, k) count
    nowhere; no rows gives no labels; ids past the rows raise."""
    indptr = torch.tensor([0, 2, 2, 5, 5])
    ids = torch.tensor([1, 2, 0, 1, 3], dtype=torch.int32)
    csr = CSR(indptr, ids, None, (4, 4))
    labels = torch.tensor([0, 1, 1, 7], dtype=torch.int32)
    got = label_prop_round(csr, labels, 3, 0.5, 10.0)
    assert got.tolist() == [1, 1, 0, 7]  # row 2's tie goes to the first part; row 3 has no entries
    counts = neighbor_counts(csr, labels, 3)
    assert counts.tolist() == [[0, 2, 0], [0, 0, 0], [1, 1, 0], [0, 0, 0]]
    assert part_counts(labels, 3).tolist() == [1, 2, 0]
    empty = CSR(torch.zeros(1, dtype=torch.int64), torch.zeros(0, dtype=torch.int32), None, (0, 0))
    assert label_prop_round(empty, torch.zeros(0, dtype=torch.int32), 3, 1.0, 1.0).shape == (0,)
    wide = CSR(indptr, ids, None, (4, 6))
    with pytest.raises(ValueError, match="name a row"):
        label_prop_round(wide, labels, 3, 0.5, 10.0)


def test_split_rows_counts_the_rows_over_split_rows():
    """``split_rows`` reports the rows longer than ``SPLIT_ROWS`` (a row of
    exactly ``SPLIT_ROWS`` stays out) and the entries they hold; K7's source
    names the same threshold; the plain round on the CPU counts no split
    round."""
    from sparsebase_tpu_torch.ops.kernels import label_prop
    from sparsebase_tpu_torch.utils import tracing

    t = label_prop.SPLIT_ROWS
    deg = torch.tensor([0, 5, t, t + 1, 3 * t, 7, t - 1])
    indptr = torch.cat([torch.zeros(1, dtype=torch.int64), deg.cumsum(0)])
    nnz = int(indptr[-1])
    csr = CSR(indptr, torch.zeros(nnz, dtype=torch.int32), None, (7, 7))
    assert label_prop.split_rows(csr) == (2, 4 * t + 1)
    empty = CSR(torch.zeros(1, dtype=torch.int64), torch.zeros(0, dtype=torch.int32), None, (0, 0))
    assert label_prop.split_rows(empty) == (0, 0)
    src = (Path(label_prop.__file__).resolve().parents[2] / "csrc" / "label_prop.cu").read_text()
    assert re.search(r"constexpr int64_t kSplitRows = (\d+);", src).group(1) == str(t)
    before = tracing.counters().get("label_prop.split_rounds", 0)
    label_prop_round(csr, torch.zeros(7, dtype=torch.int32), 2, 0.5, 4.0)
    assert tracing.counters().get("label_prop.split_rounds", 0) == before


def test_label_prop_never_falls_back_off_cpu():
    """A CSR that is not on the CPU never takes the plain version: on a
    device without the kernel the wrapper raises."""
    port, _ = graph("random-200")
    meta = port.to_device(torch.device("meta"))
    labels = torch.zeros(200, dtype=torch.int32)
    with pytest.raises(TypeMismatchError):
        label_prop_round(meta, labels.to("meta"), 4, 0.5, 55.0)
    with pytest.raises(TypeMismatchError):
        label_prop_round(port, labels.to("meta"), 4, 0.5, 55.0)  # mixed devices
    assert torch.equal(label_prop_round(port, labels, 4, 0.5, 55.0), label_prop_round_plain(port, labels, 4, 0.5, 55.0))


# -- base: edge cut, part sizes, balance ------------------------------------------------
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_edge_cut_and_balance_equal_jax(name):
    port, rcsr = graph(name)
    labels = np.random.default_rng(6).integers(0, 4, port.nrows).astype(np.int32)
    for lab in (labels, torch.from_numpy(labels), labels.tolist()):
        assert partition.edge_cut(port, lab) == ref_partition.edge_cut(rcsr, labels)
        assert partition.balance_ratio(lab, 4) == ref_partition.balance_ratio(labels, 4)
    np.testing.assert_array_equal(partition.part_sizes(labels, 4).numpy(), ref_partition.part_sizes(labels, 4))
    w = np.random.default_rng(7).integers(1, 9, port.nrows).astype(np.float64)
    got = partition.part_sizes(torch.from_numpy(labels), 4, torch.from_numpy(w))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), ref_partition.part_sizes(labels, 4, weights=w))


def test_part_sizes_drop_labels_outside_the_range():
    """A label at or past ``num_parts`` is dropped, as ``jnp.bincount(length=)``
    drops it; a negative one is dropped too, where ``jnp.bincount`` counts it
    in part 0 and ``np.bincount`` raises."""
    labels = np.array([0, 1, 1, 3, 5, 9, 2, -1, -4, 3], np.int32)
    got = partition.part_sizes(torch.from_numpy(labels), 4)
    assert got.dtype == torch.int64 and got.tolist() == [1, 2, 1, 2]
    high = labels[labels >= 0]
    np.testing.assert_array_equal(partition.part_sizes(high, 4).numpy(),
                                  np.asarray(ref_partition.part_sizes(jnp.asarray(high), 4)))
    assert np.asarray(ref_partition.part_sizes(jnp.asarray(labels), 4)).tolist() == [3, 2, 1, 2]
    w = torch.arange(10, dtype=torch.float64)
    assert partition.part_sizes(torch.from_numpy(labels), 4, w).tolist() == [0.0, 3.0, 6.0, 12.0]
    assert partition.balance_ratio(labels, 4) == 2 * 4 / 10


# -- the hypergraph model ---------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_column_net_model_and_connectivity_equal_jax(name):
    port, rcsr = graph(name)
    got = partition.column_net_hypergraph(port)
    want = ref_partition.column_net_hypergraph(rcsr)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    labels = np.random.default_rng(1).integers(0, 3, port.nrows).astype(np.int32)
    assert partition.cutsize_connectivity(*got[:2], torch.from_numpy(labels), 3) == \
        ref_partition.cutsize_connectivity(*want[:2], labels, 3)


@pytest.mark.parametrize("seed", range(6))
def test_hypergraph_label_prop_equals_jax_on_random_hypergraphs(seed):
    r = np.random.default_rng(seed)
    n_cells, n_nets = int(r.integers(10, 120)), int(r.integers(5, 80))
    pins_per = r.integers(1, 6, n_nets)
    ni = np.concatenate([[0], np.cumsum(pins_per)]).astype(np.int64)
    pins = r.integers(0, n_cells, int(pins_per.sum())).astype(np.int64)
    cw = r.uniform(0.5, 3.0, n_cells)
    k = int(r.integers(2, 5))
    got = hypergraph.hypergraph_label_prop(ni, pins, cw, hypergraph.PatohPartitionParams(num_partitions=k))
    want = ref_hypergraph.hypergraph_label_prop(ni, pins, cw, ref_hypergraph.PatohPartitionParams(num_partitions=k))
    np.testing.assert_array_equal(got, want)


def test_hypergraph_object(tmp_path):
    """``partition_hypergraph`` on a PaToH file read by each package."""
    from sparsebase_tpu.io import PatohReader as RefPatohReader
    from sparsebase_tpu_torch.io import PatohReader

    p = tmp_path / "h.patoh"
    p.write_text("0 6 4 12\n0 2\n0 1 3\n3 4 5\n2 4 5 3\n")
    got = partition.PatohPartition(num_partitions=2).partition_hypergraph(
        PatohReader(str(p), device="cpu").read_hypergraph())
    want = ref_partition.PatohPartition(num_partitions=2).partition_hypergraph(RefPatohReader(str(p)).read_hypergraph())
    assert_labels(got, want, 6, 2)
    fx.check_partition(got.numpy(), 6, 2)


# -- the anchors of tests/test_partition.py, on the port ----------------------------------
def grid_csr(side):
    indptr, indices, _ = csr_arrays(*grid_pairs(side), side * side)
    return CSR(torch.from_numpy(indptr), torch.from_numpy(indices), None, (side * side, side * side))


@pytest.mark.parametrize("k,cut,balance", [(2, 16 * 3, 1.15), (4, 48 * 3, 1.25)])
def test_metis_grid_quality(k, cut, balance):
    g = grid_csr(16)
    part = partition.MetisPartition(num_partitions=k, seed=0).partition(g)
    fx.check_partition(part.numpy(), g.nrows, k)
    assert partition.edge_cut(g, part) <= cut
    assert partition.balance_ratio(part, k) <= balance


@pytest.mark.parametrize("cls,side,k,seed,factor", [("MetisPartition", 20, 4, 1, 0.5), ("PulpPartition", 16, 2, 5, 1.0)])
def test_partitioner_beats_random(cls, side, k, seed, factor):
    g = grid_csr(side)
    part = getattr(partition, cls)(num_partitions=k, seed=seed).partition(g)
    rand = np.random.default_rng(0).integers(0, k, g.nrows).astype(np.int32)
    assert partition.edge_cut(g, part) < partition.edge_cut(g, rand) * factor


def test_pulp_grid_balance():
    g = grid_csr(16)
    part = partition.PulpPartition(num_partitions=4, seed=3).partition(g)
    fx.check_partition(part.numpy(), g.nrows, 4)
    assert partition.balance_ratio(part, 4) <= 1.2


def test_metis_recursive_bisection_balance():
    g = grid_csr(12)
    part = partition.MetisPartition(num_partitions=4, ptype="rb", seed=0).partition(g)
    fx.check_partition(part.numpy(), g.nrows, 4)
    assert partition.balance_ratio(part, 4) <= 1.3


def test_patoh_grid_connectivity_beats_random():
    g = grid_csr(12)
    part = partition.PatohPartition(num_partitions=4, seed=2).partition(g)
    fx.check_partition(part.numpy(), g.nrows, 4)
    ni, pins, _ = partition.column_net_hypergraph(g)
    rand = np.random.default_rng(0).integers(0, 4, g.nrows).astype(np.int32)
    assert partition.cutsize_connectivity(ni, pins, part, 4) < partition.cutsize_connectivity(ni, pins, rand, 4)


# -- partition_pipeline ---------------------------------------------------------------------
def pipeline_graph(seed, n, nnz, dups=True):
    """Row-major-sorted triplets, columns 20% from a clump (the benchmark
    graph), some coordinates repeated."""
    rng = np.random.default_rng(seed)
    row = rng.integers(0, n, nnz)
    col = np.where(rng.random(nnz) < 0.2, rng.integers(0, max(n // 100, 1), nnz), rng.integers(0, n, nnz))
    if dups:
        row[:10], col[:10] = row[0], col[0]
    order = np.lexsort((col, row))
    row, col = row[order].astype(np.int32), col[order].astype(np.int32)
    return row, col, rng.standard_normal(nnz).astype(np.float32), rng.standard_normal(n).astype(np.float32)


def canonical(indptr, indices, vals):
    """The entries as (row, column, value) rows in one order: the order of a
    repeated coordinate's payloads is not defined on the JAX device path."""
    row = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    order = np.lexsort((vals, indices, row))
    return row[order], np.asarray(indices)[order], np.asarray(vals)[order]


def y_bounds(row, col, vals, x, ro):
    """``P·(A@x)`` in float64 and the per-row bound of the JAX cumsum
    (ROADMAP §3): ``4·deg·eps·(|A||x|)_i + 8·eps·sqrt(nnz)·max|run|``."""
    eps = np.finfo(np.float32).eps
    prod = vals.astype(np.float64) * x.astype(np.float64)[col]
    n = x.size
    exact, absdot = np.zeros(n), np.zeros(n)
    np.add.at(exact, row, prod)
    np.add.at(absdot, row, np.abs(prod))
    deg = np.bincount(row, minlength=n)
    bound = 4 * deg * eps * absdot + 8 * eps * np.sqrt(len(row)) * np.abs(np.cumsum(prod)).max(initial=0.0)
    out_exact, out_bound = np.empty(n), np.empty(n)
    out_exact[ro], out_bound[ro] = exact, bound
    return out_exact, out_bound


# (seed, n, nnz, k, rounds)
PIPELINE_CASES = [(0, 48, 300, 4, 6), (1, 300, 2_500, 8, 10), (2, 500, 6_000, 2, 3), (3, 200, 3_000, 8, 1),
                  (4, 1_000, 12_000, 16, 10), (5, 64, 64, 8, 10)]


@pytest.mark.parametrize("case", PIPELINE_CASES, ids=lambda c: f"seed{c[0]}-n{c[1]}-k{c[3]}-rounds{c[4]}")
def test_partition_pipeline_equals_eager_jax(case):
    seed, n, nnz, k, rounds = case
    row, col, vals, x = pipeline_graph(seed, n, nnz)
    coo = COO(torch.from_numpy(row), torch.from_numpy(col), torch.from_numpy(vals), (n, n))
    permuted, y, labels = partition_pipeline(coo, torch.from_numpy(x), k, rounds)
    rcoo = ref.COO(jnp.asarray(row), jnp.asarray(col), jnp.asarray(vals), (n, n))
    rp, ry, rl = ref_partition_pipeline(rcoo, jnp.asarray(x), k, rounds)
    assert labels.dtype == torch.int32
    np.testing.assert_array_equal(labels.numpy(), np.asarray(rl))
    np.testing.assert_array_equal(permuted.indptr.numpy(), np.asarray(rp.indptr))
    np.testing.assert_array_equal(permuted.indices.numpy(), np.asarray(rp.indices))
    for a, b in zip(canonical(permuted.indptr.numpy(), permuted.indices.numpy(), permuted.vals.numpy()),
                    canonical(np.asarray(rp.indptr), np.asarray(rp.indices), np.asarray(rp.vals))):
        np.testing.assert_array_equal(a, b)
    ro = np.argsort(np.argsort(labels.numpy(), kind="stable"), kind="stable")
    exact, bound = y_bounds(row, col, vals, x, ro)
    assert np.all(np.abs(y.numpy() - exact) <= bound)
    assert np.all(np.abs(np.asarray(ry) - exact) <= bound)


@pytest.mark.parametrize("k", [4, 8])
def test_partition_pipeline_on_a_planted_graph_equals_eager_jax(k):
    """``partition_pipeline`` on a planted graph (ids shuffled): the same
    labels and permuted CSR as the JAX package's eager call."""
    n = 2_000
    indptr, col, row = planted_graph(30 + k, n, k)
    vals = np.random.default_rng(k).standard_normal(col.size).astype(np.float32)
    x = np.random.default_rng(k + 1).standard_normal(n).astype(np.float32)
    coo = COO(torch.from_numpy(row), torch.from_numpy(col), torch.from_numpy(vals), (n, n))
    permuted, y, labels = partition_pipeline(coo, torch.from_numpy(x), k, 10)
    rp, ry, rl = ref_partition_pipeline(ref.COO(jnp.asarray(row), jnp.asarray(col), jnp.asarray(vals), (n, n)),
                                        jnp.asarray(x), k, 10)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(rl))
    assert len(np.unique(labels.numpy())) > 1
    np.testing.assert_array_equal(permuted.indptr.numpy(), np.asarray(rp.indptr))
    for a, b in zip(canonical(permuted.indptr.numpy(), permuted.indices.numpy(), permuted.vals.numpy()),
                    canonical(np.asarray(rp.indptr), np.asarray(rp.indices), np.asarray(rp.vals))):
        np.testing.assert_array_equal(a, b)


def test_partition_pipeline_against_jitted_jax_is_valid():
    """Under ``jax.jit`` XLA multiplies by the reciprocal of the penalty's
    divisor instead of dividing, which can flip a near-tie: against the
    jitted call (as ``tests/test_convert.py`` runs it) both results are held
    to validity, not to each other."""
    row, col, vals, x = pipeline_graph(7, 48, 400, dups=False)
    n, k = 48, 4
    coo = COO(torch.from_numpy(row), torch.from_numpy(col), torch.from_numpy(vals), (n, n))
    rcoo = ref.COO(jnp.asarray(row), jnp.asarray(col), jnp.asarray(vals), (n, n))
    rp, ry, rl = jax.jit(ref_partition_pipeline, static_argnums=(2, 3))(rcoo, jnp.asarray(x), k, 6)
    permuted, y, labels = partition_pipeline(coo, torch.from_numpy(x), k, 6)
    for lab, out, csr_nnz in ((labels.numpy(), y.numpy(), permuted.nnz), (np.asarray(rl), np.asarray(ry), rp.nnz)):
        fx.check_partition(lab, n, k)
        assert csr_nnz == len(row)
        exact, bound = y_bounds(row, col, vals, x, np.argsort(np.argsort(lab, kind="stable"), kind="stable"))
        assert np.all(np.abs(out - exact) <= bound)


def test_partition_pipeline_needs_a_square_coo():
    coo = COO(torch.tensor([0, 1], dtype=torch.int32), torch.tensor([0, 2], dtype=torch.int32), None, (2, 3))
    with pytest.raises(ValueError, match="square"):
        partition_pipeline(coo, torch.zeros(3), 2, 2)
    assert sbt.models.partition_pipeline is partition_pipeline
