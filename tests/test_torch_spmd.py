"""The multi-controller job's modules (``tsne_flink_tpu_torch/parallel/knn``,
``parallel/symmetrize``, ``parallel/pipeline`` and the sharded
``ops/knn.knn_refine``) against the JAX package, on the port's thread mesh
(one CPU shard a thread; ``tests/test_torch_multiprocess.py`` runs the same
shards as processes).

* ``ring_knn`` at D = 2, 4, 8 against the JAX ``ring_knn`` at the same D
  (its ``shard_map`` program under ``test_torch_mesh``'s ``jax_mesh``
  fixture) and against the port's single sweep: ids equal as sets within
  runs of equal distance, distances ±1e-12, no padding and no self; every
  width gives one graph bit for bit;
* ``project_knn_sharded`` with the JAX package's draws injected (rebuilt
  with ``jax.random`` from its key schedule) at D = 2 and 4, and the
  sharded ``knn_refine`` against the JAX function called directly;
* ``symmetrize_alltoall`` at D = 2, 4, 8 (jidx, jval, both drop counters,
  ``needed``, ``nnz``), and the width and capacity escalations and
  ``sym_strict`` as the JAX tests hold them;
* ``SpmdPipeline`` against the JAX ``SpmdPipeline`` at D = 2 and 8, with
  the JAX init (and project draws) injected: y and the loss trace rtol
  1e-9 after 10 iterations.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from test_torch_mesh import jax_mesh  # noqa: F401 — the fixture
from tsne_flink_tpu.models.tsne import TsneConfig as JConfig
from tsne_flink_tpu.ops import knn as jknn
from tsne_flink_tpu.parallel import knn as jpknn
from tsne_flink_tpu.parallel import mesh as jmesh
from tsne_flink_tpu.parallel.pipeline import SpmdPipeline as JPipeline
from tsne_flink_tpu.parallel.symmetrize import \
    symmetrize_alltoall as jsymmetrize
from tsne_flink_tpu_torch.models.tsne import TsneConfig
from tsne_flink_tpu_torch.ops import knn as tknn
from tsne_flink_tpu_torch.ops.affinities import pairwise_affinities
from tsne_flink_tpu_torch.parallel.knn import (project_knn_sharded,
                                               ring_knn)
from tsne_flink_tpu_torch.parallel.mesh import padded_rows_for, run_shards
from tsne_flink_tpu_torch.parallel.pipeline import SpmdPipeline
from tsne_flink_tpu_torch.parallel.symmetrize import symmetrize_alltoall

pytestmark = pytest.mark.fast

N, K, PERPLEXITY = 45, 8, 4.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _blobs(n=N, d=6, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(3, d)) * 4.0
    return centers[rng.integers(0, 3, n)] + rng.normal(size=(n, d))


def _t(a):
    return torch.from_numpy(np.array(a))


def _padded(a, d, fill=0.0):
    npad = padded_rows_for(a.shape[0], d) - a.shape[0]
    return np.pad(a, ((0, npad),) + ((0, 0),) * (a.ndim - 1),
                  constant_values=fill)


def _threads(d, fn):
    """``fn(axis)`` on a thread mesh of d CPU shards, in shard order."""
    return run_shards(["cpu"] * d, fn)


def _jax_shards(d, fn, n_in, n_out, *args, replicated_out=()):
    """The JAX function ``fn`` in a ``shard_map`` over d CPU devices."""
    from tsne_flink_tpu.utils import compat
    outs = tuple(jmesh.rspec() if i in replicated_out else jmesh.pspec()
                 for i in range(n_out))
    return jax.jit(compat.shard_map(fn, mesh=jmesh.make_mesh(d),
                                    in_specs=(jmesh.pspec(),) * n_in,
                                    out_specs=outs))(*args)


def _same_graph(ti, td, ji, jd):
    """Distances ±1e-12; ids equal as sets within each run of equal
    (reference) distance."""
    ti, td, ji, jd = map(np.asarray, (ti, td, ji, jd))
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-12)
    for r in range(ji.shape[0]):
        s = 0
        while s < ji.shape[1]:
            e = s + 1
            while e < ji.shape[1] and jd[r, e] == jd[r, s]:
                e += 1
            assert set(ti[r, s:e]) == set(ji[r, s:e]), (r, ti[r], ji[r])
            s = e


# ---- ring_knn ---------------------------------------------------------------

def _ring(x, d, metric, k=K):
    xp = _t(_padded(x, d))
    nl = xp.shape[0] // d
    outs = _threads(d, lambda ax: ring_knn(
        xp[ax.index * nl:(ax.index + 1) * nl], k, x.shape[0], metric,
        axis=ax))
    return (torch.cat([o[0] for o in outs]).numpy(),
            torch.cat([o[1] for o in outs]).numpy())


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "cosine"])
def test_ring_knn_matches_jax_and_the_single_sweep(jax_mesh, metric):
    x = _blobs()
    ti1, td1 = _ring(x, 1, metric)
    si, sd = tknn.knn_bruteforce(_t(x), K, metric)
    _same_graph(ti1[:N], td1[:N], si.numpy(), sd.numpy())
    for d in (2, 4, 8):
        ti, td = _ring(x, d, metric)
        # one graph at every width, padding rows included
        np.testing.assert_array_equal(ti, ti1)
        np.testing.assert_array_equal(td, td1)
        xp = jnp.asarray(_padded(x, d))
        ji, jd = _jax_shards(d, lambda xl, d=d: jpknn.ring_knn(
            xl, K, d, N, metric), 1, 2, xp)
        # the real rows (the JAX cosine gives a zero padding row nan)
        _same_graph(ti[:N], td[:N], np.asarray(ji)[:N], np.asarray(jd)[:N])
    # padding never a neighbour, self never its own
    assert (ti1 < N).all() and (ti1 >= 0).all()
    assert not (ti1 == np.arange(ti1.shape[0])[:, None]).any()


def test_ring_hop_plain_version_is_shape_free():
    """The cross sweep's plain version gives a pair the same bits in any
    block, so a row's hop against a block equals its slice of the hop
    against the whole set (the single-sweep contract of the kernel)."""
    from tsne_flink_tpu_torch.ops.knn_cuda import knn_cross_plain
    x = _t(_blobs(n=60, d=7, seed=3))
    d_all, i_all = knn_cross_plain(x[10:30], x, 60, False, 10, 0, 57)
    d_blk, i_blk = knn_cross_plain(x[10:30], x[20:50], 60, False, 10, 20, 57)
    # the block's columns are ids 20..49: every finite entry of the block
    # hop appears, with the same bits, in the whole hop
    for r in range(20):
        whole = dict(zip(i_all[r].tolist(), d_all[r].tolist()))
        for j, dv in zip(i_blk[r].tolist(), d_blk[r].tolist()):
            if j >= 0:
                assert whole[j] == dv
        assert (i_blk[r] >= 0).sum() == 30 - (20 <= 10 + r < 50)
    # masked: ids past n_global, and each row's own id
    assert not ((i_all >= 57) | (i_all == torch.arange(10, 30)[:, None])
                ).any() and (i_all == -1).sum() == 20 * 4


# ---- the sharded project kNN and refine -------------------------------------

def _sharded_round_draw(rkey, it, dim, m=3):
    """round_perm's draws: both split off the round's key."""
    pkey, skey = jax.random.split(rkey)
    proj = (_t(jax.random.normal(pkey, (dim, m), jnp.float64)
               / jnp.sqrt(jnp.asarray(dim, jnp.float64)))
            if dim > m else None)
    shift = (_t(jax.random.uniform(skey, (1, m), jnp.float64))[0]
             if it > 0 else None)
    return tknn.ProjectDraw(proj=proj, shift=shift)


def _refine_draw(rkey, plan, nloc, npts, k, dim):
    """knn_refine's draws in the sharded form: gateway scores of the local
    shape, the reverse order of the global graph's edges."""
    _, gkey, vkey, fkey, ckey = jax.random.split(rkey, 5)
    scale = jnp.sqrt(jnp.asarray(dim, jnp.float64))

    def gauss(kk, width):
        return _t(jax.random.normal(kk, (dim, width), jnp.float64) / scale)

    return tknn.RefineDraw(
        gate=(_t(jax.random.uniform(gkey, (nloc, k), jnp.float64))
              if plan.s < k else None),
        rev=_t(jax.random.permutation(vkey, npts * k)),
        filt=gauss(fkey, plan.filter_dims) if plan.filter_dims else None,
        casc=gauss(ckey, plan.cascade_dims) if plan.cascade_dims else None)


def _plan(dim, k):
    fd = tknn.pick_knn_filter(dim)
    return tknn._refine_plan(dim, k, filter_dims=fd,
                             expand_k=(k + 1) // 2 if fd else None)


def _project_draws(key, dim, k, rounds, refine, nloc, npts):
    """project_knn_sharded's whole key schedule."""
    draws = []
    for it in range(rounds):
        key, rkey = jax.random.split(key)
        draws.append(_sharded_round_draw(rkey, it, dim))
    for _ in range(refine):
        for _z in range(tknn.ZORDER_PER_CYCLE):
            key, zkey = jax.random.split(key)
            draws.append(_sharded_round_draw(zkey, 1, dim))
        key, rkey = jax.random.split(key)
        draws.append(_refine_draw(rkey, _plan(dim, k), nloc, npts, k, dim))
    return draws


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("metric,dim", [("sqeuclidean", 6), ("cosine", 300)])
def test_project_knn_sharded_matches_jax_with_its_draws(jax_mesh, d, metric,
                                                        dim):
    k, rounds, refine, block = 10, 2, 1, 16
    x = _blobs(d=dim, seed=5)
    xp = _padded(x, d)
    npts = xp.shape[0]
    nl = npts // d
    key = jax.random.key(3)
    ji, jd = _jax_shards(d, lambda xl: jpknn.project_knn_sharded(
        xl, k, d, N, metric, rounds=rounds, key=key, block=block,
        refine_rounds=refine), 1, 2, jnp.asarray(xp))
    draws = _project_draws(key, dim, k, rounds, refine, nl, npts)
    xt = _t(xp)
    outs = _threads(d, lambda ax: project_knn_sharded(
        xt[ax.index * nl:(ax.index + 1) * nl], k, N, metric, rounds,
        axis=ax, draws=draws, block=block, refine_rounds=refine))
    ti = torch.cat([o[0] for o in outs]).numpy()
    td = torch.cat([o[1] for o in outs]).numpy()
    _same_graph(ti[:N], td[:N], np.asarray(ji)[:N], np.asarray(jd)[:N])
    assert (ti[:N] < N).all()


@pytest.mark.parametrize("shard", [1, 3])
@pytest.mark.parametrize("metric,dim,k", [("sqeuclidean", 6, 10),
                                          ("euclidean", 300, 12)])
def test_sharded_refine_matches_jax(shard, metric, dim, k):
    """The sharded refine (x_full, idx_full, row_offset, n_valid) against
    the JAX function called directly: shard 3 of 4 holds the padding
    rows, whose lists are self-loops."""
    d = 4
    x = _blobs(d=dim, seed=7)
    i0, d0 = tknn.knn_project(_t(x), k, metric, 1, block=8)  # not exact
    xp = _padded(x, d)
    npts = xp.shape[0]
    nl = npts // d
    gids = np.arange(npts)
    idx_full = np.concatenate([i0.numpy(), gids[N:, None].repeat(k, 1)])
    dist_full = np.concatenate([d0.numpy(), np.full((npts - N, k), np.inf)])
    rows = slice(shard * nl, (shard + 1) * nl)
    fd = tknn.pick_knn_filter(dim)
    ke = (k + 1) // 2 if fd else None
    key = jax.random.key(9)
    ji, jd = jknn.knn_refine(
        jnp.asarray(xp[rows]), jnp.asarray(idx_full[rows], jnp.int32),
        jnp.asarray(dist_full[rows]), metric, rounds=1, key=key,
        x_full=jnp.asarray(xp), idx_full=jnp.asarray(idx_full, jnp.int32),
        row_offset=shard * nl, n_valid=N, filter_dims=fd, expand_k=ke)
    draw = _refine_draw(key, _plan(dim, k), nl, npts, k, dim)
    ti, td = tknn.knn_refine(
        _t(xp[rows]), _t(idx_full[rows].astype(np.int32)),
        _t(dist_full[rows]), metric, rounds=1, draws=[draw],
        x_full=_t(xp), idx_full=_t(idx_full.astype(np.int32)),
        row_offset=shard * nl, n_valid=N, filter_dims=fd, expand_k=ke)
    _same_graph(ti.numpy(), td.numpy(), ji, jd)
    real = rows.start + np.arange(nl) < N
    assert (ti.numpy()[real] < N).all()


# ---- symmetrize_alltoall -----------------------------------------------------

def _graph_p(d, n=N, k=K):
    x = _blobs(n=n)
    i, dist = tknn.knn_bruteforce(_t(x), k)
    p = pairwise_affinities(dist, PERPLEXITY).numpy()
    return (_padded(i.numpy(), d).astype(np.int32), _padded(p, d))


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("width,slack", [(32, 4), (8, 4), (32, 1)],
                         ids=["clean", "width-drops", "capacity-drops"])
def test_symmetrize_alltoall_matches_jax(jax_mesh, d, width, slack):
    idx, p = _graph_p(d)
    nl = idx.shape[0] // d
    jout = _jax_shards(d, lambda i, pp: jsymmetrize(
        i, pp, d, width, slack=slack), 2, 5, jnp.asarray(idx),
        jnp.asarray(p), replicated_out=(2, 3, 4))
    ti_, tp_ = _t(idx), _t(p)
    outs = _threads(d, lambda ax: symmetrize_alltoall(
        ti_[ax.index * nl:(ax.index + 1) * nl],
        tp_[ax.index * nl:(ax.index + 1) * nl], width, slack=slack,
        axis=ax))
    np.testing.assert_array_equal(
        torch.cat([o[0] for o in outs]).numpy(), np.asarray(jout[0]))
    np.testing.assert_allclose(torch.cat([o[1] for o in outs]).numpy(),
                               np.asarray(jout[1]), rtol=0, atol=1e-12)
    for o in outs:  # every shard holds the same counters
        assert o[2].tolist() == np.asarray(jout[2]).tolist()
        assert int(o[3]) == int(jout[3]) and int(o[4]) == int(jout[4])
    if width == 8:
        assert outs[0][2][1] > 0
    if slack == 1 and d > 1:
        assert outs[0][2][0] > 0


def _hub_precomputed(n=48, k=7):
    rng = np.random.default_rng(3)
    idx = np.tile(np.arange(k, dtype=np.int32), (n, 1))
    for i in range(k):  # no self-loops
        idx[i, i] = k
    return idx, np.sort(rng.uniform(0.5, 2.0, (n, k)), axis=1)


def test_alltoall_capacity_escalates_and_heals_like_jax(jax_mesh):
    """Every transpose edge routes to shard 0: the auto slack doubles and
    reruns until nothing drops (the JAX test's graph), P exactly
    symmetric and equal to the JAX pipeline's; a pinned slack keeps its
    drops (warns) or fails under sym_strict."""
    idx, dist = _hub_precomputed()
    n, k = idx.shape
    cfg = TsneConfig(iterations=2, repulsion="exact", perplexity=3.0)
    jcfg = JConfig(iterations=2, repulsion="exact", row_chunk=8,
                   perplexity=3.0)
    pipe = SpmdPipeline(cfg, n, 4, k, knn_method="precomputed",
                        sym_mode="alltoall", n_devices=8, device="cpu")
    ji, jv, _ = pipe.prepare((_t(idx), _t(dist)))
    jpipe = JPipeline(jcfg, n, 4, k, knn_method="precomputed",
                      sym_mode="alltoall", n_devices=8)
    rj = jpipe.prepare((jnp.asarray(idx), jnp.asarray(dist)),
                       jax.random.key(0))
    assert pipe._slack_escalations >= 1 and pipe.sym_slack > 4
    assert (pipe.sym_slack, pipe._slack_escalations) == (
        jpipe.sym_slack, jpipe._slack_escalations)
    np.testing.assert_array_equal(ji.numpy(), np.asarray(rj[0]))
    np.testing.assert_allclose(jv.numpy(), np.asarray(rj[1]), rtol=0,
                               atol=1e-12)
    pm = np.zeros((n, n))
    np.add.at(pm, (np.repeat(np.arange(n), ji.shape[1]),
                   ji.numpy().reshape(-1)), jv.numpy().reshape(-1))
    np.testing.assert_array_equal(pm, pm.T)
    np.testing.assert_allclose(pm.sum(), 1.0, rtol=1e-12)
    pinned = SpmdPipeline(cfg, n, 4, k, knn_method="precomputed",
                          sym_mode="alltoall", sym_slack=1, n_devices=8,
                          device="cpu")
    pinned.prepare((_t(idx), _t(dist)))
    assert pinned.sym_slack == 1 and pinned._slack_escalations == 0
    strict = SpmdPipeline(cfg, n, 4, k, knn_method="precomputed",
                          sym_mode="alltoall", sym_slack=1, sym_strict=True,
                          n_devices=8, device="cpu")
    with pytest.raises(RuntimeError, match="capacity cap"):
        strict.prepare((_t(idx), _t(dist)))


def test_auto_width_escalates_on_hub_rows():
    """A hub every point is nearest to: the auto width adopts the measured
    one and gives the bits of a generously pinned width (strict, clean),
    and a pinned narrow width fails under sym_strict."""
    n, d, k = 40, 40, 3
    x = np.zeros((n, d))
    for i in range(1, n):
        x[i, i - 1] = 1.0  # a simplex 1 from the hub, sqrt(2) apart
    cfg = TsneConfig(iterations=6, repulsion="exact", perplexity=2.0,
                     attraction="rows")
    pipe = SpmdPipeline(cfg, n, d, k, n_devices=8, device="cpu")
    first = pipe.sym_width
    y_auto, l_auto = pipe(_t(x), 3)
    assert pipe.sym_width > first and pipe._escalations >= 1
    y_pin, l_pin = SpmdPipeline(cfg, n, d, k, sym_width=pipe.sym_width,
                                sym_strict=True, n_devices=8,
                                device="cpu")(_t(x), 3)
    assert torch.equal(y_auto, y_pin) and torch.equal(l_auto, l_pin)
    y_s, _ = SpmdPipeline(cfg, n, d, k, sym_strict=True, n_devices=8,
                          device="cpu")(_t(x), 3)
    assert torch.equal(y_s, y_pin)
    with pytest.raises(RuntimeError, match="sym_width overflow"):
        SpmdPipeline(cfg, n, d, k, sym_width=8, sym_strict=True,
                     n_devices=8, device="cpu")(_t(x), 3)


# ---- SpmdPipeline against the JAX class --------------------------------------

ARMS = [("bruteforce", "replicated"), ("bruteforce", "alltoall"),
        ("project", "replicated"), ("precomputed", "replicated")]


@pytest.mark.parametrize("d", [2, 8])
@pytest.mark.parametrize("method,mode", ARMS,
                         ids=[f"{m}-{s}" for m, s in ARMS])
def test_spmd_pipeline_matches_jax(jax_mesh, d, method, mode):
    """prepare: the P rows (ids equal, values ±1e-12) and the init, with
    the JAX init and project draws injected; optimize: 10 iterations from
    the JAX package's P and init through the runner the pipeline builds
    (``ShardedOptimizer`` with the pre-padded rows and the measured edge
    count), y within 1e-9 of the embedding's extent and the loss trace
    rtol 1e-9.  End to end the 1e-16 differences of P grow through the
    early-exaggeration iterations (ROADMAP "Parity"): y within 1e-6 of
    the extent, the final KL rtol 1e-9."""
    from tsne_flink_tpu_torch.models.tsne import TsneState
    from tsne_flink_tpu_torch.parallel.mesh import ShardedOptimizer
    dim, k, iters = 6, 10, 10
    x = _blobs(d=dim, seed=11)
    jcfg = JConfig(perplexity=PERPLEXITY, iterations=iters,
                   repulsion="exact")
    cfg = TsneConfig(perplexity=PERPLEXITY, iterations=iters,
                     repulsion="exact")
    key = jax.random.key(5)
    refine = 1 if method == "project" else None
    if method == "precomputed":
        gi, gd = tknn.knn_bruteforce(_t(x), k)
        jdata = (jnp.asarray(gi.numpy()), jnp.asarray(gd.numpy()))
        tdata = (gi, gd)
    else:
        jdata, tdata = jnp.asarray(x), _t(x)
    jp = JPipeline(jcfg, N, dim, k, knn_method=method, sym_mode=mode,
                   knn_refine=refine, n_devices=d)
    jidx, jval, jstate = jp.prepare(jdata, key)
    jy, jl = jp(jdata, key)
    n_pad = padded_rows_for(N, d)
    draws = None
    if method == "project":
        draws = _project_draws(jax.random.fold_in(key, 1), dim, k,
                               jp.knn_rounds, 1, n_pad // d, n_pad)
    tp = SpmdPipeline(cfg, N, dim, k, knn_method=method, sym_mode=mode,
                      knn_refine=refine, n_devices=d, device="cpu")
    y0 = np.asarray(jstate.y)
    tidx, tval, tstate = tp.prepare(tdata, 0, y0=y0, knn_draws=draws)
    assert tp.sym_width == jp.sym_width
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tval.numpy(), np.asarray(jval), rtol=0,
                               atol=1e-12)
    assert torch.equal(tstate.y, _t(y0))
    span = float(np.abs(np.asarray(jy)).max())
    # the optimize stage from the JAX package's P and init
    opt = ShardedOptimizer(cfg, N, devices=tp.devices)
    npad = n_pad - N
    st, losses = opt(
        TsneState(_t(y0), torch.zeros_like(_t(y0)), torch.ones_like(_t(y0))),
        _t(_padded(np.asarray(jidx), d)), _t(_padded(np.asarray(jval), d)),
        pre_padded_valid=torch.arange(n_pad) < N, unpad=False,
        edge_pad=max(8, (tp.nnz_ + 7) // 8 * 8))
    assert st.y.shape[0] == N + npad
    np.testing.assert_allclose(st.y[:N].numpy(), np.asarray(jy), rtol=0,
                               atol=1e-9 * span)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), rtol=1e-9)
    # end to end
    ty, tl = tp(tdata, 0, y0=y0, knn_draws=draws)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                               atol=1e-6 * span)
    np.testing.assert_allclose(tl.numpy()[-1], np.asarray(jl)[-1],
                               rtol=1e-9)
