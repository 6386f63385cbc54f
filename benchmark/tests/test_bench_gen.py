"""The generators: GAP's Kronecker graph and HPCG's stencil, at tiny sizes."""

import json

import torch

from benchmark.core.spec import Spec
from benchmark.gen import kronecker, stencil27

SEED = 2**31 + 977  # past 32 signed bits: a run's seed may be
CPU = torch.device("cpu")


def kron_cfg(**over):
    cfg = dict(Spec().config("gap-kron-s25"), scale=10)
    cfg.update(over)
    return cfg


def hpcg_cfg(**over):
    cfg = dict(Spec().config("hpcg-27pt-256"), nx=8, ny=8, nz=8)
    cfg.update(over)
    return cfg


def dense(g):
    n = g["n"]
    a = torch.zeros((n, n), dtype=torch.float64)
    a.index_put_((g["row"].long(), g["col"].long()), g["vals"].double(), accumulate=True)
    return a


def test_kron_quadrant_shares_are_graph500s():
    gen = torch.Generator().manual_seed(5)
    scale, count = 10, 1 << 16
    u, v = kronecker.draw_edges(gen, scale, count, 0.57, 0.19, 0.19, CPU)
    ub = torch.stack([(u >> lvl) & 1 for lvl in range(scale)])
    vb = torch.stack([(v >> lvl) & 1 for lvl in range(scale)])
    total = scale * count
    shares = [float(((ub == i) & (vb == j)).sum()) / total for i, j in ((0, 0), (0, 1), (1, 0), (1, 1))]
    for got, want in zip(shares, (0.57, 0.19, 0.19, 0.05)):
        assert abs(got - want) < 0.005, shares


def test_kron_is_symmetric_sorted_without_loops_or_duplicates():
    g = kronecker.make(kron_cfg(), SEED, CPU)
    n, row, col = g["n"], g["row"].long(), g["col"].long()
    assert n == 1024 and g["row"].dtype == torch.int32 and g["vals"].dtype == torch.float32
    assert not bool((row == col).any())
    key = row * n + col
    assert bool((key[1:] > key[:-1]).all())  # row-major, strictly: no duplicates
    a = dense(g)
    assert torch.equal(a, a.T)
    assert float(g["vals"].min()) >= 1 and float(g["vals"].max()) <= 255
    assert torch.equal(g["vals"], g["vals"].round())
    assert 0.5 * 2 * 16 * n < row.numel() <= 2 * 16 * n
    assert float(g["x"].min()) >= -1 and float(g["x"].max()) < 1


def test_kron_keeps_the_least_weight_of_duplicates():
    """GAP's SquishCSR keeps, of equal coordinates, the least weight: every
    stored weight is the least drawn for its pair."""
    cfg = kron_cfg(scale=4, edge_factor=16)  # 256 edges on 16 vertices: many duplicates
    g = kronecker.make(cfg, SEED, CPU)
    gen = torch.Generator().manual_seed(cfg["graph_seed"])
    perm = torch.randperm(16, generator=gen)
    u, v = kronecker.draw_edges(gen, 4, 256, cfg["A"], cfg["B"], cfg["C"], CPU)
    w = torch.randint(1, 256, (256,), generator=gen, dtype=torch.int64)
    u, v = perm[u], perm[v]
    least = {}
    for a, b, x in zip(u.tolist(), v.tolist(), w.tolist()):
        if a != b:
            for key in ((a, b), (b, a)):
                least[key] = min(x, least.get(key, 256))
    got = {(r, c): x for r, c, x in zip(g["row"].tolist(), g["col"].tolist(), g["vals"].tolist())}
    assert got == {k: float(x) for k, x in least.items()}


def test_kron_sorted_by_row_ranges_is_one_sort(monkeypatch):
    """Set-up sorts the stored entries one range of rows at a time; many
    ranges give the graph that one sort of all the entries gives."""
    one = kronecker.make(kron_cfg(), SEED, CPU)
    monkeypatch.setattr(kronecker, "PART", 1 << 10)
    many = kronecker.make(kron_cfg(), SEED, CPU)
    for key in ("row", "col", "vals", "x"):
        assert torch.equal(one[key], many[key]), key


def test_kron_ids_are_permuted():
    """Vertex 0 collects the most edges as drawn (quadrant A at every level);
    after the permutation another vertex does."""
    cfg = kron_cfg()
    u, _ = kronecker.draw_edges(torch.Generator().manual_seed(1), 10, 1 << 14, cfg["A"], cfg["B"], cfg["C"], CPU)
    assert int(torch.bincount(u, minlength=1024).argmax()) == 0
    g = kronecker.make(cfg, SEED, CPU)
    assert int(torch.bincount(g["row"].long(), minlength=g["n"]).argmax()) != 0


def test_generators_are_deterministic_in_the_seed():
    for gen, cfg in ((kronecker, kron_cfg()), (stencil27, hpcg_cfg())):
        one, two, other = gen.make(cfg, SEED, CPU), gen.make(cfg, SEED, CPU), gen.make(cfg, SEED + 1, CPU)
        for key in ("row", "col", "vals", "x"):
            assert torch.equal(one[key], two[key])
        assert not torch.equal(one["x"], other["x"])
    # the graph is the configuration's, the same for every seed
    assert torch.equal(kronecker.make(kron_cfg(), SEED, CPU)["col"], kronecker.make(kron_cfg(), SEED + 1, CPU)["col"])
    assert not torch.equal(kronecker.make(kron_cfg(), SEED, CPU)["col"],
                           kronecker.make(kron_cfg(graph_seed=1), SEED, CPU)["col"])


def test_hpcg_counts_rows_and_values():
    g = stencil27.make(hpcg_cfg(), SEED, CPU)
    n, row, col = g["n"], g["row"].long(), g["col"].long()
    assert n == 512 and row.numel() == (3 * 8 - 2) ** 3 == 10648
    key = row * n + col
    assert bool((key[1:] > key[:-1]).all())
    deg = torch.bincount(row, minlength=n).reshape(8, 8, 8)  # (z, y, x)
    assert bool((deg[1:-1, 1:-1, 1:-1] == 27).all())
    assert int(deg.min()) == 8 and int(deg[0, 0, 0]) == 8 and int(deg[0, 0, 3]) == 12 and int(deg[0, 3, 3]) == 18
    a = dense(g)
    assert torch.equal(a, a.T)
    assert bool((torch.diagonal(a) == 26).all())
    off = g["vals"][row != col]
    assert bool((off == -1).all())
    # row (z, y, x) = (2, 3, 4) reaches (z+1, y-1, x+1)
    r = 2 * 64 + 3 * 8 + 4
    assert a[r, r + 64 - 8 + 1] == -1


def test_the_configurations_hold_their_published_numbers():
    kron = Spec().config("gap-kron-s25")
    assert (kron["A"], kron["B"], kron["C"], kron["edge_factor"], kron["weights"]) == (0.57, 0.19, 0.19, 16, [1, 255])
    assert kron["scale"] == 25 and kron["reduced"]["scale"]["published"] == 27
    hpcg = Spec().config("hpcg-27pt-256")
    assert (hpcg["diagonal"], hpcg["off_diagonal"]) == (26.0, -1.0)
    for entry in json.loads((Spec().root / "BENCHMARK.json").read_text())["configs"]:
        cfg = Spec().config(entry["name"])
        assert sorted(entry["reduced"]) == sorted(cfg["reduced"])
