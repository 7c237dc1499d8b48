"""The JAX package's CLI program on one device, for the port's CLI tests.

``tsne_flink_tpu.utils.cli.main`` runs its optimize loop through the mesh
pipeline (``parallel/mesh.ShardedOptimizer``), which does not trace under
jax 0.9 (a ``lax.cond`` varying-manual-axes mismatch; ROADMAP §C).  Its mesh-1 program is the single-device
``models/tsne.optimize`` with the same inputs, so the port's CLI is held
against that: the JAX reader, the JAX ``prepare``, the CLI's init
(``init_working_set(key(randomState))``), ``_plan_layout`` and
``optimize`` over the same schedule segments, and the JAX checkpoint
writer with the payload the CLI writes.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tsne_flink_tpu.models import tsne as jtsne
from tsne_flink_tpu.utils import artifacts as jart
from tsne_flink_tpu.utils import checkpoint as jckpt
from tsne_flink_tpu.utils import io as jio


def prepare_file(path, dimension, *, knn_method="bruteforce",
                 perplexity=30.0, dtype=jnp.float32, distance_matrix=False,
                 seed=0):
    """``(n, prep, prep_kwargs)``: the JAX CLI's ingest and prepare."""
    kw = dict(neighbors=3 * int(perplexity), knn_method=knn_method,
              metric="sqeuclidean", knn_blocks=1,
              key=jax.random.key(seed), perplexity=perplexity,
              assembly="auto")
    if distance_matrix:
        ids, idx, dist = jio.read_distance_matrix(path)
        kw.update(knn=(jnp.asarray(idx), jnp.asarray(dist, dtype)),
                  neighbors=idx.shape[1])
    else:
        ids, x = jio.read_input(path, dimension)
        kw["x"] = jnp.asarray(x, dtype)
    return len(ids), jart.prepare(**kw), kw


def optimize(state, jidx, jval, cfg, start_iter=0, loss_carry=None):
    """The CLI's single-device optimize from ``start_iter`` to the end."""
    edges, csr = jtsne._plan_layout(jidx, jval, cfg)
    n_slots = max(cfg.n_loss_slots, 1)
    if loss_carry is not None:
        loss_carry = jnp.asarray(loss_carry, state.y.dtype)
        if loss_carry.shape[0] < n_slots:
            loss_carry = jnp.pad(loss_carry,
                                 (0, n_slots - loss_carry.shape[0]))
        loss_carry = loss_carry[:n_slots]
    run = jax.jit(partial(jtsne.optimize, cfg=cfg, edges_extra=False,
                          num_iters=cfg.iterations - start_iter))
    out = run(state, jidx, jval, start_iter=start_iter,
              loss_carry=loss_carry, edges=edges, csr=csr)
    return out[0], out[1]


def _run(path, dimension, *, iterations, seed=0, n_components=2, **kw):
    """The JAX CLI's program on ``path`` (``--nComponents``:
    ``n_components``): ``(state, losses, prep, prep_kwargs)``."""
    dtype = kw.get("dtype", jnp.float32)
    n, prep, prep_kw = prepare_file(path, dimension, seed=seed, **kw)
    cfg = jtsne.TsneConfig(n_components=n_components,
                           perplexity=kw.get("perplexity", 30.0),
                           iterations=iterations)
    state = jtsne.init_working_set(jax.random.key(seed), n, n_components,
                                   dtype)
    st, losses = optimize(state, prep.jidx, prep.jval, cfg)
    return st, losses, prep, prep_kw


def embed_file(path, dimension, *, iterations=300, **kw):
    """``(y, losses)`` of the JAX CLI's program on ``path``."""
    st, losses, _, _ = _run(path, dimension, iterations=iterations, **kw)
    return np.asarray(st.y), np.asarray(losses)


def fat_checkpoint(path, ckpt_path, dimension, *, iterations, **kw):
    """Run ``iterations`` and write the fat v2 checkpoint the JAX CLI
    writes at the end of the run (``--checkpoint --fatCheckpoint``)."""
    st, losses, prep, prep_kw = _run(path, dimension,
                                     iterations=iterations, **kw)
    _, fp = jart.prepare_fingerprints(**prep_kw)
    jckpt.save(ckpt_path, st, iterations, np.asarray(losses),
               prepare={"label": prep.label, "affinity_fp": fp,
                        "jidx": prep.jidx, "jval": prep.jval})


def resume(ckpt_path, *, iterations, perplexity=30.0):
    """The JAX CLI's ``--resume`` of a fat checkpoint to ``iterations``."""
    st, start, losses = jckpt.load(ckpt_path)
    payload = jckpt.load_prepare(ckpt_path)
    cfg = jtsne.TsneConfig(perplexity=perplexity, iterations=iterations)
    state = jtsne.TsneState(*(jnp.asarray(a) for a in st))
    st, losses = optimize(state, jnp.asarray(payload["jidx"]),
                          jnp.asarray(payload["jval"]), cfg,
                          start_iter=start, loss_carry=losses)
    return np.asarray(st.y), np.asarray(losses)
