"""PyTorch port, the CSR step (B3 over head + tail, one launch on the card)
and its layout (``build_csr`` as tensor code) vs the JAX package.

* The plain B3 — head block, ragged tail, rep and Z — against the JAX
  ``fused_step_update`` fed the JAX ``_edge_forces`` tail and rep / Z,
  through its XLA twin in float64 (±1e-9), with and without a padded-row
  mask, at m = 1, 2, 3 and 8, on a hub-heavy graph whose CSR has a real
  tail; and in float32 through the Pallas kernel in interpret mode.
* One float32 ``optimize`` iteration: the fused CSR step equals the
  unfused one (B5's plain forces over head + tail, att − rep/Z, the vdM
  update) bit for bit; so does one plain step, with and without a head
  block.
* ``build_csr`` against the JAX package's numpy build, array for array:
  with a tail, without one, at W = S, with an all-zero row, and with the
  last row holding the tail.
* The visit order (the rows with the longest tails first) is a
  permutation and moves no bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsne_flink_tpu.models.tsne import _edge_forces
from tsne_flink_tpu.ops import attraction_pallas as jatt
from tsne_flink_tpu_torch.models import tsne as ttsne
from tsne_flink_tpu_torch.models.tsne import _without_padding
from tsne_flink_tpu_torch.ops import attraction_cuda as tatt

pytestmark = pytest.mark.fast

EXAG, MOMENTUM, ETA, MIN_GAIN = 4.0, 0.8, 200.0, 0.01


def _hub_rows(n=160, s=48, seed=0, dtype=np.float64):
    """Padded rows [n, s] of a hub-heavy graph: most rows hold 3-14 set
    entries, every 16th row is a hub with 30-48, set slots scattered
    among unset ones (val 0) so a row's order matters."""
    rng = np.random.default_rng(seed)
    jidx = rng.integers(0, n, (n, s)).astype(np.int32)
    jval = np.zeros((n, s), dtype)
    for r in range(n):
        deg = rng.integers(30, s + 1) if r % 16 == 0 else rng.integers(3, 15)
        cols = np.sort(rng.choice(s, deg, replace=False))
        jval[r, cols] = rng.random(deg) * 1e-2 + 1e-4
    return jidx, jval


def _state(n, m, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((n, m)).astype(dtype)
    rep = (40.0 * 1e-2 * rng.standard_normal((n, m))).astype(dtype)
    upd = (1e-2 * rng.standard_normal((n, m))).astype(dtype)
    gains = (1.0 + rng.random((n, m))).astype(dtype)
    return y, rep, upd, gains


def _csr_both(jidx, jval, width):
    """The JAX build (numpy) and the port's, and the port's ragged tail."""
    jhead, jtail = jatt.build_csr(jidx, jval, width)
    thead, ttail = tatt.build_csr(torch.from_numpy(jidx),
                                  torch.from_numpy(jval), width)
    rag = tatt.ragged_edges(*_without_padding(ttail), jidx.shape[0])
    return (jhead, jtail), (thead, ttail, rag)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("m", [1, 2, 3, 8])
def test_plain_step_matches_jax_fused_step_f64(m, masked):
    jidx, jval = _hub_rows(seed=m)
    n = jidx.shape[0]
    (jhead, jtail), (thead, _, rag) = _csr_both(jidx, jval, 16)
    assert int(rag.dst.shape[0]) > 100, "the hubs must overflow the head"
    y, rep, upd, gains = _state(n, m, 10 + m)
    z = 40.0
    valid = (np.arange(n) % 7 != 3) if masked else None
    j = jnp.asarray
    tail_att = _edge_forces(j(y), j(y), *jtail, jnp.float64(EXAG))
    want = jatt.fused_step_update(
        j(y), j(y), *jhead, jnp.float64(EXAG), tail_att,
        j(rep) / jnp.float64(z), None if valid is None else j(valid), j(upd),
        j(gains), jnp.float64(MOMENTUM), eta=ETA, min_gain=MIN_GAIN,
        row_chunk=64, kernel="xla")
    t = torch.from_numpy
    got = tatt.fused_step_update(
        t(y), t(y), *thead, EXAG, t(rep), torch.tensor(z, dtype=torch.float64),
        None if valid is None else t(valid), t(upd), t(gains), MOMENTUM,
        eta=ETA, min_gain=MIN_GAIN, ragged=rag, row_chunk=48)
    for a, b in zip(got, want):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-9)
    if masked:  # a masked row's grad is 0: pure momentum decay
        off = ~valid
        np.testing.assert_allclose(got[1].numpy()[off], MOMENTUM * upd[off],
                                   rtol=1e-15, atol=0)
        assert torch.all(got[3][t(off)] == 0)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Let the JAX package's Pallas kernels run in interpret mode: jax 0.9's
    ``pallas_call`` takes only int ``CostEstimate`` fields and the package
    passes floats, so they are rounded while the test runs, and what was
    traced under the patch is dropped afterwards."""
    from jax.experimental import pallas as pl
    orig = pl.CostEstimate
    monkeypatch.setattr(pl, "CostEstimate", lambda **kw: orig(
        **{k: int(v) for k, v in kw.items()}))
    yield
    monkeypatch.undo()
    jax.clear_caches()


def test_plain_step_matches_jax_pallas_kernel_f32(pallas_interpret):
    """In float32 against the JAX Pallas kernel (interpret mode), on
    tie-free inputs: the gains exactly equal, y and update to rtol 1e-4."""
    jidx, jval = _hub_rows(seed=5, dtype=np.float32)
    n, m = jidx.shape[0], 2
    (jhead, jtail), (thead, _, rag) = _csr_both(jidx, jval, 16)
    y, rep, upd, gains = _state(n, m, 6, np.float32)
    j = jnp.asarray
    tail_att = _edge_forces(j(y), j(y), *jtail, jnp.float32(EXAG))
    want = jatt.fused_step_update(
        j(y), j(y), *jhead, jnp.float32(EXAG), tail_att,
        j(rep) / jnp.float32(40.0), None, j(upd), j(gains),
        jnp.float32(MOMENTUM), eta=ETA, min_gain=MIN_GAIN, row_chunk=64,
        kernel="pallas-interpret")
    t = torch.from_numpy
    got = tatt.fused_step_update(t(y), t(y), *thead, EXAG, t(rep),
                                 torch.tensor(40.0), None, t(upd), t(gains),
                                 MOMENTUM, eta=ETA, min_gain=MIN_GAIN,
                                 ragged=rag, row_chunk=48)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("start", [0, 149])
def test_one_f32_iteration_fused_equals_unfused(start, masked):
    """One float32 ``optimize`` iteration over the CSR layout: the fused
    step (B3's plain version over head + tail) and the unfused step (B5's
    plain version over head + tail, att − rep/Z, the vdM update) give the
    same bits — y, update, gains and the loss trace."""
    jidx, jval = _hub_rows(seed=2, dtype=np.float32)
    n = jidx.shape[0]
    head, tail = tatt.build_csr(torch.from_numpy(jidx),
                                torch.from_numpy(jval), 16)
    y, _, upd, gains = _state(n, 2, 3, np.float32)
    y = y * (1e-4 if start == 0 else 5.0)
    valid = torch.from_numpy(np.arange(n) < n - 9) if masked else None
    cfg = ttsne.TsneConfig(perplexity=5.0, iterations=300, row_chunk=64)
    outs = []
    for fused in (None, False):
        st = ttsne.TsneState(*map(torch.from_numpy, (y, upd, gains)))
        outs.append(ttsne.optimize(st, torch.from_numpy(jidx),
                                   torch.from_numpy(jval), cfg, valid=valid,
                                   start_iter=start, num_iters=1,
                                   csr=head + tail, fused_step=fused))
    for a, b in zip(outs[0][0], outs[1][0]):
        assert a.dtype == torch.float32
        assert torch.equal(a, b)
    assert torch.equal(outs[0][1], outs[1][1])


def _zero_row(jidx, jval):
    jval = jval.copy()
    jval[5] = 0.0
    return jidx, jval


def _last_row_hub(jidx, jval):
    jval = jval.copy()
    jval[-1] = np.linspace(1e-3, 2e-3, jval.shape[1])
    jval[-1, ::5] = 0.0
    return jidx, jval


@pytest.mark.parametrize("case,width", [
    ("tail", 16),          # hubs overflow into the tail
    ("no tail", 48),       # W >= every row's degree, and W = S
    ("w above s", 64),     # W clipped to S
    ("zero row", 16),      # a row with no set entry
    ("last row holds the tail", 8),
])
def test_build_csr_matches_jax_build(case, width):
    jidx, jval = _hub_rows(seed=9)
    if case == "zero row":
        jidx, jval = _zero_row(jidx, jval)
    if case == "last row holds the tail":
        jidx, jval = _last_row_hub(jidx, jval)
        jval[:-1, 8:] = 0.0  # no other row overflows W = 8
    (jhead, jtail), (thead, ttail, _) = _csr_both(jidx, jval, width)
    for a, b in zip(thead + ttail, jhead + jtail):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b)
    n_tail = int((ttail[2] > 0).sum())
    if case in ("no tail", "w above s"):
        assert n_tail == 0 and thead[0].shape[1] == jidx.shape[1]
    else:
        assert n_tail > 0
    if case == "zero row":
        assert not torch.any(thead[1][5] > 0)
    if case == "last row holds the tail":
        assert torch.all(ttail[0][:n_tail] == jidx.shape[0] - 1)


def test_visit_order_puts_the_hubs_first_and_moves_no_bit():
    jidx, jval = _hub_rows(seed=4, dtype=np.float32)
    n = jidx.shape[0]
    head, tail = tatt.build_csr(torch.from_numpy(jidx),
                                torch.from_numpy(jval), 16)
    rag = tatt.ragged_edges(*_without_padding(tail), n)
    y, rep, upd, gains = map(torch.from_numpy, _state(n, 3, 8, np.float32))
    order = tatt.visit_order(rag)
    assert order.dtype == torch.int32
    assert torch.equal(torch.sort(order).values,
                       torch.arange(n, dtype=torch.int32))
    lengths = torch.diff(rag.rowptr)[order.long()]
    assert torch.all(lengths[:-1] >= lengths[1:])  # longest tails first
    hubs = int((lengths > 0).sum())
    assert 0 < hubs < n
    # among rows with equal tails, index order
    rest = order[hubs:]
    assert torch.all(rest[:-1] < rest[1:])
    args = (y, y, *head, EXAG, rep, torch.tensor(40.0), None, upd, gains,
            MOMENTUM)
    kw = dict(eta=ETA, min_gain=MIN_GAIN, ragged=rag, row_chunk=48)
    plain = tatt.fused_step_update(*args, **kw)
    for perm in (order, torch.randperm(n).to(torch.int32)):
        ordered = tatt.fused_step_update(*args, order=perm, **kw)
        for a, b in zip(plain, ordered):
            assert torch.equal(a, b)


@pytest.mark.parametrize("head", [True, False])
def test_plain_step_is_the_unfused_step_over_the_same_parts(head):
    """The plain step over head + tail, or over the tail alone (no head
    block, W = 0), against B5's plain forces over the same parts, att −
    rep/Z and ``models/tsne._update_embedding``: the same bits, as the
    kernels give on the card."""
    jidx, jval = _hub_rows(seed=6, dtype=np.float32)
    n = jidx.shape[0]
    (hidx, hval), tail = tatt.build_csr(torch.from_numpy(jidx),
                                        torch.from_numpy(jval), 16)
    rag = tatt.ragged_edges(*_without_padding(tail), n)
    blk = (hidx, hval) if head else (None, None)
    y, rep, upd, gains = map(torch.from_numpy, _state(n, 2, 7, np.float32))
    z = torch.tensor(40.0)
    got = tatt.fused_step_update(y, y, *blk, EXAG, rep, z, None, upd, gains,
                                 MOMENTUM, eta=ETA, min_gain=MIN_GAIN,
                                 ragged=rag, row_chunk=48)
    att = tatt.attraction_forces(y, y, *blk, EXAG, ragged=rag, row_chunk=48)
    cfg = ttsne.TsneConfig(learning_rate=ETA, min_gain=MIN_GAIN)
    want = ttsne._update_embedding(ttsne.TsneState(y, upd, gains),
                                   att - rep / z, MOMENTUM, cfg)
    for a, b in zip(got[:3], want):
        assert torch.equal(a, b)
