"""The plain references and the comparisons, against dense arithmetic and
loops at tiny sizes."""

import torch

from benchmark.reference import compare
from benchmark.reference import csr as ref_csr
from benchmark.reference import dia as ref_dia
from benchmark.reference import labelprop as ref_lp

CPU = torch.device("cpu")


def small_coo(seed=3, n=40, nnz=300):
    g = torch.Generator().manual_seed(seed)
    key = torch.unique(torch.randint(0, n * n, (nnz,), generator=g))
    row, col = (key // n).to(torch.int32), (key % n).to(torch.int32)
    row = torch.cat([row, torch.full((60,), 7, dtype=torch.int32)])  # one long row
    col = torch.cat([col, torch.arange(60, dtype=torch.int32) % n])
    key = row.long() * n + col.long()
    order = torch.sort(key, stable=True).indices
    vals = torch.randint(1, 256, (key.numel(),), generator=g).to(torch.float32)
    x = torch.rand((n,), generator=g) * 2 - 1
    return {"n": n, "row": row[order], "col": col[order], "vals": vals[order], "x": x}


def dense(inp):
    a = torch.zeros((inp["n"], inp["n"]), dtype=torch.float64)
    a.index_put_((inp["row"].long(), inp["col"].long()), inp["vals"].double(), accumulate=True)
    return a


def test_indptr_rank_and_spmv():
    inp = small_coo()
    indptr = ref_csr.indptr_from_rows(inp["row"], inp["n"])
    assert torch.equal(indptr[1:] - indptr[:-1], torch.bincount(inp["row"].long(), minlength=inp["n"]))
    keys = torch.tensor([3, 1, 3, 0, 1])
    assert ref_csr.stable_rank(keys).tolist() == [3, 1, 4, 0, 2]
    y, absdot = ref_csr.spmv(inp["row"], inp["col"], inp["vals"], inp["x"], inp["n"])
    a = dense(inp)
    assert torch.allclose(y, a @ inp["x"].double(), rtol=0, atol=1e-12)
    assert torch.allclose(absdot, a.abs() @ inp["x"].double().abs(), rtol=0, atol=1e-12)


def permuted_dense(inp, rank):
    """``P A P^T`` entry by entry, rows' columns ascending, ties in input order."""
    n = inp["n"]
    entries = sorted((int(rank[r]), int(rank[c]), i, float(v))
                     for i, (r, c, v) in enumerate(zip(inp["row"], inp["col"], inp["vals"])))
    indptr = [0] * (n + 1)
    for r, _, _, _ in entries:
        indptr[r + 1] += 1
    for i in range(n):
        indptr[i + 1] += indptr[i]
    return indptr, [c for _, c, _, _ in entries], [v for _, _, _, v in entries]


def test_permuted_rows_match_a_loop():
    inp = small_coo()
    indptr = ref_csr.indptr_from_rows(inp["row"], inp["n"])
    rank = ref_csr.stable_rank(indptr[1:] - indptr[:-1])
    want_ptr, want_col, want_val = permuted_dense(inp, rank)
    new_indptr = ref_csr.permuted_indptr(indptr, ref_csr.inverse(rank))
    assert new_indptr.tolist() == want_ptr
    cols, vals = [], []
    for lo, hi, ncol, nval in ref_csr.permuted_rows(indptr, inp["col"], inp["vals"], rank, new_indptr):
        assert lo == len(cols)
        cols += ncol.tolist()
        vals += nval.tolist()
    assert cols == want_col and vals == want_val
    got = {"indptr": torch.tensor(want_ptr), "indices": torch.tensor(want_col, dtype=torch.int32),
           "vals": torch.tensor(want_val, dtype=torch.float32)}
    assert ref_csr.csr_mismatches(got["indptr"], got["indices"], got["vals"], indptr, inp["col"], inp["vals"], rank) == 0
    got["indices"][5] += 1
    got["vals"][9] += 1
    assert ref_csr.csr_mismatches(got["indptr"], got["indices"], got["vals"], indptr, inp["col"], inp["vals"], rank) == 2
    short = got["indices"][:-3]
    assert ref_csr.csr_mismatches(got["indptr"], short, got["vals"], indptr, inp["col"], inp["vals"], rank) >= 3


def test_permutation_numbers_and_their_control():
    inp = small_coo()
    indptr = ref_csr.indptr_from_rows(inp["row"], inp["n"])
    rank = ref_csr.stable_rank(indptr[1:] - indptr[:-1])
    exact = compare.permuted_control(inp, rank, indptr)
    a = dense(inp)
    y = torch.empty(inp["n"], dtype=torch.float64)
    y[rank] = a @ inp["x"].double()
    exact["y"] = y.to(torch.float32)  # float32 rounding of the exact answer
    nums = compare.permutation_numbers(exact, inp, rank, indptr)
    assert nums["csr_mismatch"] == 0 and nums["y_err"] < 1e-6
    ctl = compare.permutation_numbers(compare.permuted_control(inp, rank, indptr), inp, rank, indptr)
    assert ctl["csr_mismatch"] == 0 and ctl["y_err"] > 1e-3  # bfloat16 fails the row gap
    nan = dict(exact, y=torch.full_like(exact["y"], float("nan")))
    assert compare.permutation_numbers(nan, inp, rank, indptr)["y_err"] == compare.NOT_FINITE


def test_band_and_iterate_against_dense():
    g = torch.Generator().manual_seed(4)
    n = 30
    row = torch.arange(n).repeat_interleave(3)
    col = (row + torch.tensor([-2, 0, 5]).repeat(n)).clamp(0, n - 1)
    key = torch.unique(row * n + col)
    inp = {"n": n, "row": (key // n).to(torch.int32), "col": (key % n).to(torch.int32),
           "vals": torch.randn(key.numel(), generator=g), "x": torch.rand(n, generator=g)}
    offsets, data = ref_dia.band(inp["row"], inp["col"], inp["vals"], n, torch.float64)
    a = dense(inp)
    want = {int(o) for o in (inp["col"].long() - inp["row"].long()).unique()}
    assert set(offsets.tolist()) == want and offsets.tolist() == sorted(want)
    for d, o in enumerate(offsets.tolist()):
        for i in range(n):
            assert data[d, i] == (a[i, i + o] if 0 <= i + o < n else 0)
    x = inp["x"].double()
    for _ in range(3):
        x = (a @ x) / 7.0
    assert torch.allclose(ref_dia.iterate(offsets, data, inp["x"], 3, 7.0), x, rtol=1e-12, atol=0)
    got = {"offsets": offsets.to(torch.int32), "data": data.to(torch.float32),
           "x": ref_dia.iterate(offsets, data, inp["x"], 3, 7.0).to(torch.float32)}
    nums = compare.band_numbers(got, inp, 3, 7.0)
    assert nums["dia_mismatch"] == 0 and nums["x_err"] < 1e-6
    got["data"][1, 3] += 1
    assert compare.band_numbers(got, inp, 3, 7.0)["dia_mismatch"] == 1


def test_label_rounds_match_a_loop():
    inp = small_coo(seed=8, n=24, nnz=160)
    n, k, rounds = inp["n"], 3, 4
    indptr = ref_csr.indptr_from_rows(inp["row"], n)
    got = ref_lp.propagate(inp["row"], inp["col"], indptr[1:] - indptr[:-1], n, k, rounds)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    labels = [(v * k) // n for v in range(n)]
    cap = 1.1 * n / k
    rows = [[int(c) for r, c in zip(inp["row"], inp["col"]) if int(r) == v] for v in range(n)]
    for i in range(rounds):
        counts = [[float(sum(labels[c] == p for c in rows[v])) for p in range(k)] for v in range(n)]
        top = max(max(c) for c in counts)
        sizes = [labels.count(p) for p in range(k)]
        pen = [f32((i + 1) / rounds) * torch.clamp_min(f32(sizes[p]) - f32(cap), 0.0) * (f32(top) + 1.0)
               / f32(max(cap, 1.0)) for p in range(k)]
        new = []
        for v in range(n):
            scores = [f32(counts[v][p]) - pen[p] for p in range(k)]
            best = max(range(k), key=lambda p: (float(scores[p]), -p))
            new.append(best if rows[v] else labels[v])
        labels = new
    assert got.tolist() == labels
