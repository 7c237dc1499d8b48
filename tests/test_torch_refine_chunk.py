"""PyTorch port, the refine chunk's funnel stages (kernel B6's plain
versions, ``ops/knn_cuda.refine_keep_plain`` / ``refine_final_plain``)
against the JAX package's ``knn_refine`` (f64, CPU), one round with the
JAX draws injected, on the rows the card kernel must get right:

* duplicated gateways (mutual neighbours put one id in both halves) and
  self among the candidates (a neighbour's list holds the row itself);
* exact distance ties (integer-lattice points), sqeuclidean, and
  euclidean with ties after the sqrt;
* rows with fewer unique candidates than the funnel keeps;
* the chunk size, which never changes a bit.

Each case also holds the plain stages to the kernel's contract, stated
here in numpy: the unique candidates less the row itself, ranked by
(score, tie) with tie = the id in a chunk's first stage and the previous
stage's rank after it, and the exact stage's k best merged into the old
list at each id's smallest distance, ordered by (distance, id).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsne_flink_tpu.ops import knn as jknn
from tsne_flink_tpu_torch.ops import knn as tknn
from tsne_flink_tpu_torch.ops import knn_cuda as kc

pytestmark = pytest.mark.fast


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def _lattice(n, d, seed):
    """Integer points: every distance is exact in f64, and many tie."""
    return np.random.default_rng(seed).integers(0, 3, (n, d)).astype(
        np.float64)


def _gauss(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d))


def _exact(x, idx, metric):
    """The rows' distances to their listed ids, ascending by (d, id)."""
    xt = _t(x)
    d = torch.sum((xt[:, None, :] - xt[idx.long()]) ** 2, dim=-1)
    if metric == "euclidean":
        d = torch.sqrt(d)
    key = torch.argsort(idx, dim=1, stable=True)
    idx, d = torch.gather(idx, 1, key), torch.gather(d, 1, key)
    order = torch.argsort(d, dim=1, stable=True)
    return torch.gather(idx, 1, order), torch.gather(d, 1, order)


def _ring(n, k):
    """Row i's neighbours are i ± 1, i ± 2, ...: every edge is mutual, so
    each row's out- and in-gateways overlap, and each gateway's list holds
    the row itself."""
    off = np.array([(j // 2 + 1) * (1 - 2 * (j % 2)) for j in range(k)])
    return ((np.arange(n)[:, None] + off[None, :]) % n).astype(np.int32)


def _clique(n, k, m):
    """Rows 0 .. m-1 list only each other (m − 1 > k), the rest a ring
    among themselves: a clique row has at most m − 1 unique candidates."""
    rng = np.random.default_rng(m)
    idx = np.empty((n, k), np.int32)
    for i in range(m):
        others = np.array([j for j in range(m) if j != i])
        idx[i] = rng.permutation(others)[:k]
    idx[m:] = m + _ring(n - m, k)
    return idx


def _jax_refine_draw(key, plan, n, k, dim):
    """One knn_refine round's draws, from its own key schedule."""
    _, gkey, vkey, fkey, ckey = jax.random.split(key, 5)
    scale = jnp.sqrt(jnp.asarray(dim, jnp.float64))

    def gauss(kk, width):
        return _t(jax.random.normal(kk, (dim, width), jnp.float64) / scale)

    return tknn.RefineDraw(
        gate=(_t(jax.random.uniform(gkey, (n, k), jnp.float64))
              if plan.s < k else None),
        rev=_t(jax.random.permutation(vkey, n * k)),
        filt=gauss(fkey, plan.filter_dims) if plan.filter_dims else None,
        casc=gauss(ckey, plan.cascade_dims) if plan.cascade_dims else None)


def _funnel(d, k):
    fd = tknn.pick_knn_filter(d)
    return dict(filter_dims=fd, expand_k=(k + 1) // 2 if fd else None)


def _against_jax(x, idx, metric, seed):
    """One refine round of both packages from one graph; the port's
    result."""
    n, d = x.shape
    k = idx.shape[1]
    i0, d0 = _exact(x, _t(idx), metric)
    kw = _funnel(d, k)
    key = jax.random.key(seed)
    ri, rd = jknn.knn_refine(jnp.asarray(x), jnp.asarray(i0.numpy()),
                             jnp.asarray(d0.numpy()), metric, rounds=1,
                             key=key, **kw)
    plan = tknn._refine_plan(d, k, **kw)
    draw = _jax_refine_draw(key, plan, n, k, d)
    qi, qd = tknn.knn_refine(_t(x), i0, d0, metric, rounds=1, draws=[draw],
                             **kw)
    ri, rd = np.asarray(ri), np.asarray(rd)
    np.testing.assert_allclose(qd.numpy(), rd, rtol=1e-10, atol=1e-12)
    if metric == "euclidean":
        # XLA's CPU sqrt is not correctly rounded: sqrt(32) comes out one
        # ulp above torch's, so an exact tie between an old (torch) and a
        # new (XLA) distance may order the other way.  Within a run of
        # equal distances the ids must agree as a set, in id order.
        ri = _by_rounded_distance(ri, rd)
        qi = _t(_by_rounded_distance(qi.numpy(), qd.numpy()))
    np.testing.assert_array_equal(qi.numpy(), ri)
    return i0, d0, plan, draw


def _by_rounded_distance(idx, dist):
    """Each row's ids ordered by (distance to 12 significant digits, id)."""
    key = np.round(dist / np.maximum(np.abs(dist[:, -1:]), 1e-300), 12)
    order = np.lexsort((idx, key), axis=1)
    return np.take_along_axis(idx, order, axis=1)


# ---- the kernel's contract, in numpy ---------------------------------------

def _gateways(idx, plan, draw, k):
    """knn_refine's deduped gateway rows u [n, 2s] for one round."""
    n = idx.shape[0]
    rows = torch.arange(n)
    gidx = idx.long()
    s = plan.s
    if s < k:
        score = draw.gate.clone()
        score[:, :max(1, s // 2)] = -np.inf
        _, gsel = tknn._topk_smallest(score, s)
        gate = torch.gather(gidx, 1, gsel)
    else:
        gate = gidx[:, :s]
    rev = tknn._reverse_sample(idx, s, perm=draw.rev).long()
    rev = torch.where(rev < 0, rows[:, None], rev)
    us = torch.sort(torch.cat([gate, rev], dim=1), dim=1).values
    dup = torch.zeros_like(us, dtype=torch.bool)
    dup[:, 1:] = us[:, 1:] == us[:, :-1]
    return torch.where(dup, rows[:, None], us)


def _contract_candidates(row, gates, idx, ke):
    ids = set(gates.tolist())
    for g in gates.tolist():
        ids.update(idx[g, :ke].tolist())
    ids.discard(row)
    return sorted(ids)


def _scores(base, sq, row, ids, root=False):
    d = kc.cand_sqdist_plain(base, sq, torch.tensor([row]),
                             torch.tensor([ids], dtype=torch.long))[0]
    return torch.sqrt(d) if root else d


def _contract_select(scores, ties, want):
    order = sorted(range(len(ties)), key=lambda t: (float(scores[t]),
                                                    ties[t]))
    return order[:want]


def _contract_chunk(x, xcache, stages_in, row0, u, idx, dist, plan,
                    metric):
    """Per row: the keep stages' ids and the new (ids, dists), as the
    kernel computes them."""
    k = idx.shape[1]
    out = []
    for r in range(u.shape[0]):
        row = row0 + r
        ids = _contract_candidates(row, u[r], idx, plan.ke)
        ties = list(ids)  # the first stage: ties by id
        stages = []
        for base, sq, keep in stages_in:
            sel = _contract_select(_scores(base, sq, row, ids), ties, keep)
            ids = [ids[t] for t in sel]
            ties = list(range(len(ids)))  # after it: by rank
            stages.append(list(ids))
        d = _scores(x, xcache, row, ids, metric == "euclidean")
        sel = _contract_select(d, ties, k)
        best = {int(i): float(v) for i, v in zip(idx[row], dist[row])}
        for t in sel:
            best[ids[t]] = min(best.get(ids[t], np.inf), float(d[t]))
        merged = sorted(best.items(), key=lambda e: (e[1], e[0]))[:k]
        out.append((stages, [e[0] for e in merged], [e[1] for e in merged]))
    return out


def _check_contract(x, idx, dist, plan, draw, metric, row0, c):
    """The plain stages on rows row0 .. row0 + c − 1 against the contract;
    returns how many rows had duplicated gateways, self among their
    candidates, and fewer unique candidates than the first stage keeps."""
    n, dim = x.shape
    k = idx.shape[1]
    xt = _t(x)
    xcache = torch.sum(xt * xt, dim=1)
    stages_in = []
    for mat, keep in ((draw.filt, plan.keep), (draw.casc, plan.keep2)):
        if mat is not None:
            p = (xt @ mat).contiguous()
            stages_in.append((p, torch.sum(p * p, dim=1), keep))
    u = _gateways(idx, plan, draw, k)[row0:row0 + c]
    want = _contract_chunk(xt, xcache, stages_in, row0, u, idx, dist, plan,
                           metric)
    cand, bad, first = u, None, dict(graph=idx, ke=plan.ke)
    for stage, (base, sq, keep) in enumerate(stages_in):
        cand, bad = kc.refine_keep_plain(base, sq, row0, cand, keep,
                                         bad=bad, **first)
        first = {}
        for r in range(c):
            valid = cand[r][~bad[r]].tolist()
            assert valid == want[r][0][stage], (stage, r)
    ni, nd = kc.refine_final_plain(metric, xt, xcache, row0, cand,
                                   idx[row0:row0 + c], dist[row0:row0 + c],
                                   bad=bad, **first)
    for r in range(c):
        assert ni[r].tolist() == want[r][1], r
        np.testing.assert_allclose(nd[r].numpy(), want[r][2], rtol=1e-12)
    rows = torch.arange(row0, row0 + c)
    cand0, bad0 = kc.refine_candidates_plain(row0, u, idx, plan.ke)
    dup_gates = int((u == rows[:, None]).any(dim=1).sum())
    has_self = int((cand0 == rows[:, None]).any(dim=1).sum())
    unique = (~bad0).sum(dim=1)
    return dup_gates, has_self, int((unique < plan.keep).sum())


# ---- the cases -------------------------------------------------------------

def test_duplicated_gateways_and_self_match_jax():
    """A ring graph: every edge mutual, so gateways repeat (each repeat
    becomes the row's own id) and every gateway's list holds the row."""
    x = _gauss(240, 20, 1)
    idx = _ring(240, 10)
    i0, d0, plan, draw = _against_jax(x, idx, "sqeuclidean", 1)
    dup, self_, _ = _check_contract(x, i0, d0, plan, draw, "sqeuclidean",
                                    0, 240)
    assert dup == 240 and self_ == 240


@pytest.mark.parametrize("metric,d,k", [("sqeuclidean", 40, 12),
                                        ("euclidean", 40, 12),
                                        ("sqeuclidean", 300, 12),
                                        ("euclidean", 300, 40)])
def test_lattice_ties_match_jax(metric, d, k):
    """Integer-lattice points: exact ties in the exact stage (and, for
    euclidean, after the sqrt), broken by id in the first stage, by rank
    after a keep stage, and by id in the merge."""
    n = 260
    x = _lattice(n, d, d + k)
    idx = tknn.knn_project(_t(x), k, metric, 1, block=32)[0].numpy()
    i0, d0, plan, draw = _against_jax(x, idx, metric, 2)
    assert (plan.filter_dims is not None or plan.cascade_dims is not None) \
        == (d == 300)
    _check_contract(x, i0, d0, plan, draw, metric, 37, 50)
    # the data does tie: equal distances within rows of the result
    out = tknn.knn_refine(_t(x), i0, d0, metric, rounds=1, draws=[draw],
                          **_funnel(d, k))[1]
    assert int((out[:, 1:] == out[:, :-1]).sum()) > n


def test_fewer_unique_candidates_than_keep_match_jax():
    """Rows of a 20-clique propose at most 19 unique candidates, fewer
    than the JL stage keeps (96) and the cascade (36)."""
    x = _gauss(300, 300, 3)
    idx = _clique(300, 12, 20)
    i0, d0, plan, draw = _against_jax(x, idx, "sqeuclidean", 3)
    assert plan.filter_dims and plan.cascade_dims
    assert plan.keep == 96 and plan.keep2 == 36
    *_, short = _check_contract(x, i0, d0, plan, draw, "sqeuclidean", 0, 30)
    assert short >= 20


@pytest.mark.parametrize("metric,d", [("sqeuclidean", 300),
                                      ("euclidean", 40)])
def test_chunk_size_changes_no_bit(metric, d):
    """Lattice ties, a clique and the funnel: chunks of 1, 7 and all rows
    give the same bits."""
    n, k = 200, 12
    x = _lattice(n, d, 5)
    idx = _clique(n, k, 20)
    i0, d0 = _exact(x, _t(idx), metric)
    outs = []
    for chunk in (1, 7, n):
        gen = torch.Generator().manual_seed(4)
        outs.append(tknn.knn_refine(_t(x), i0, d0, metric, rounds=2,
                                    generator=gen, row_chunk=chunk,
                                    **_funnel(d, k)))
    for i, dd in outs[1:]:
        assert torch.equal(i, outs[0][0]) and torch.equal(dd, outs[0][1])


def test_stage_wrappers_take_the_plain_version_on_the_cpu():
    """refine_keep / refine_final on CPU tensors are the plain stages, and
    a kernel stage's list (-1 for no candidate, no mask) reads as the
    plain mask would."""
    x = _gauss(120, 300, 6)
    idx = _clique(120, 12, 20)
    i0, d0 = _exact(x, _t(idx), "sqeuclidean")
    xt = _t(x)
    sq = torch.sum(xt * xt, dim=1)
    u = i0[:10, :8].long()
    got = kc.refine_keep(xt, sq, 0, u, 30, graph=i0, ke=6)
    want = kc.refine_keep_plain(xt, sq, 0, u, 30, graph=i0, ke=6)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    lst = torch.where(want[1], -1, want[0])
    a = kc.refine_final("sqeuclidean", xt, sq, 0, want[0], i0[:10], d0[:10],
                        bad=want[1])
    b = kc.refine_final("sqeuclidean", xt, sq, 0, lst, i0[:10], d0[:10])
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="CPU"):
        kc.cand_sqdist(xt.to("meta"), sq, torch.arange(3), u[:3])
