"""Dtype contracts of the port's ops — the dtype-contract registry (port
of ``tsne_flink_tpu/analysis/audit/contracts.py``).

Every function of ``ops/`` that launches a kernel counted in
``kernels/build.KERNELS``, and every ``ops/`` function the main path
calls (``models/tsne.py``, ``utils/artifacts.py``), declares here what
the dtype-contract auditor holds it to (the ``audit-contract`` lint rule
enumerates them):

* ``out`` — the dtypes of the op's flattened tensor outputs when fed the
  registry's representative float32 inputs (the deployment case; the
  kernels' float64 forms keep a float64 run in float64, as the CPU's
  plain versions do);
* ``make(device)`` — ``(fn, args)``: a call of the op on tiny seeded
  inputs on ``device``;
* ``matmul_dim`` — when set, the op's distance or projection products
  contract over this feature width, and ``make(device,
  matmul_dtype=torch.bfloat16)`` makes the same call under bf16 operands
  (the dtype audit's bf16 pass, as the JAX registry's ``matmul_dim``).

A kernel's launcher is held through the public wrapper the main path
calls (``fused_knn`` for ``knn_sweep_cuda``, ``knn_cross`` for
``knn_cross_cuda``, ``knn_refine`` for B6's ``_refine_launch``): on the
card that launches the kernel (its float64 form on float64 inputs: every
kernel, B6 included, has one), on the CPU its plain version.

Declarations are plain ``contract(...)`` calls so the lint rule can read
them with ``ast`` alone; this module is imported by the audit tier only.
"""

from __future__ import annotations

from dataclasses import dataclass

#: representative sizes: points, features, neighbours, components
N, D, K, M = 96, 12, 8, 2
PERPLEXITY = 3.0


@dataclass(frozen=True)
class OpContract:
    name: str        # dotted registry key; last segment = def name
    path: str        # repo-relative file, for findings
    out: tuple       # expected output dtypes (flattened, in order)
    make: object     # (device[, matmul_dtype]) -> (fn, args)
    matmul_dim: int | None = None  # the products' feature width


REGISTRY: dict[str, OpContract] = {}


def contract(name: str, path: str, out: tuple, make,
             matmul_dim: int | None = None) -> None:
    REGISTRY[name] = OpContract(name, path, tuple(out), make, matmul_dim)


def declared_names() -> set:
    """Bare function names with a contract (what the lint rule checks)."""
    return {c.name.rsplit(".", 1)[-1] for c in REGISTRY.values()}


# ---- representative inputs (seeded, tiny) -----------------------------------

def _x(device, n=N, d=D):
    import torch

    from tsne_flink_tpu_torch.analysis.audit.cases import blobs
    return torch.as_tensor(blobs(n, d, seed=1), device=device)


def _y(device, n=N, m=M, seed=2):
    import torch
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((n, m), generator=g) * 0.5).to(device)


def _graph(device):
    """(idx int32 [N, K], dist float32 [N, K]): the exact kNN graph."""
    from tsne_flink_tpu_torch.ops.knn import knn
    return knn(_x(device), K, "bruteforce")


def _rows(device):
    """(jidx int32, jval float32): the symmetrized P rows."""
    from tsne_flink_tpu_torch.ops.affinities import affinity_pipeline
    idx, dist = _graph(device)
    return affinity_pipeline(idx, dist, PERPLEXITY, assembly="sorted")


def _csr(device):
    from tsne_flink_tpu_torch.ops.affinities import plan_attraction
    from tsne_flink_tpu_torch.ops.attraction_cuda import (build_csr,
                                                          ragged_edges)
    jidx, jval = _rows(device)
    _layout, width = plan_attraction(jidx, jval, "csr")
    (hidx, hval), tail = build_csr(jidx, jval, width)
    return hidx, hval, ragged_edges(*tail, N)


def _landmarks(device):
    import torch
    return torch.arange(0, N, 3, device=device)


# ---- ops/knn.py, ops/knn_cuda.py --------------------------------------------

_KNN = "tsne_flink_tpu_torch/ops/knn.py"
_KC = "tsne_flink_tpu_torch/ops/knn_cuda.py"


#: the feature width of the refine funnel's case: past 2·CASCADE_DIMS, so
#: its JL filter and cascade projections run
D_FUNNEL = 300


def _mk_knn(device, matmul_dtype=None):
    from tsne_flink_tpu_torch.ops.knn import knn
    return (lambda x: knn(x, K, "bruteforce", matmul_dtype=matmul_dtype),
            (_x(device),))


def _mk_sweep(device, matmul_dtype=None):
    from tsne_flink_tpu_torch.ops.knn_cuda import fused_knn
    return (lambda x: fused_knn(x, K, matmul_dtype=matmul_dtype),
            (_x(device),))


def _mk_cross(device, matmul_dtype=None):
    from tsne_flink_tpu_torch.ops.knn_cuda import knn_cross
    x = _x(device)
    half = N // 2
    return (lambda a, b: knn_cross(a, b, K, False, 0, half, N,
                                   matmul_dtype=matmul_dtype),
            (x[:half].contiguous(), x[half:].contiguous()))


def _mk_refine(device, matmul_dtype=None):
    import torch

    from tsne_flink_tpu_torch.ops.knn import knn_project, knn_refine

    def fn(x):
        gen = torch.Generator(device=x.device).manual_seed(0)
        idx, dist = knn_project(x, K, rounds=1, generator=gen,
                                matmul_dtype=matmul_dtype)
        return knn_refine(x, idx, dist, rounds=1, generator=gen,
                          matmul_dtype=matmul_dtype)
    return fn, (_x(device),)


def _mk_funnel(device, matmul_dtype=None):
    """The refine round's JL filter + cascade funnel (d = 300)."""
    import torch

    from tsne_flink_tpu_torch.ops.knn import knn_project, knn_refine

    def fn(x):
        gen = torch.Generator(device=x.device).manual_seed(0)
        idx, dist = knn_project(x, K, rounds=1, generator=gen,
                                matmul_dtype=matmul_dtype)
        return knn_refine(x, idx, dist, rounds=1, generator=gen,
                          filter_dims=32, expand_k=K // 2,
                          matmul_dtype=matmul_dtype)
    return fn, (_x(device, d=D_FUNNEL),)


def _mk_queries(device, matmul_dtype=None):
    from tsne_flink_tpu_torch.ops.knn import knn_queries
    x = _x(device)
    return (lambda q, b: knn_queries(q, b, K, matmul_dtype=matmul_dtype),
            (x[:16].contiguous(), x))


def _mk_pairwise(device, matmul_dtype=None):
    from tsne_flink_tpu_torch.ops.metrics import pairwise
    x = _x(device)
    return (lambda a, b: pairwise("sqeuclidean", a, b, matmul_dtype),
            (x[:16].contiguous(), x))


contract("ops.knn.knn", _KNN, ("int32", "float32"), _mk_knn, matmul_dim=D)
contract("ops.knn_cuda.knn_sweep_cuda", _KC, ("int32", "float32"),
         _mk_sweep, matmul_dim=D)
contract("ops.knn_cuda.knn_cross_cuda", _KC, ("int32", "float32"),
         _mk_cross, matmul_dim=D)
contract("ops.knn_cuda._refine_launch", _KC, ("int32", "float32"),
         _mk_refine, matmul_dim=D)
contract("ops.knn.knn_refine", _KNN, ("int32", "float32"), _mk_funnel,
         matmul_dim=D_FUNNEL)
contract("ops.knn.knn_queries", _KNN, ("int32", "float32"), _mk_queries,
         matmul_dim=D)
contract("ops.metrics.pairwise", "tsne_flink_tpu_torch/ops/metrics.py",
         ("float32",), _mk_pairwise, matmul_dim=D)


# ---- ops/affinities.py ------------------------------------------------------

_AFF = "tsne_flink_tpu_torch/ops/affinities.py"


def _mk_pipeline(device):
    from tsne_flink_tpu_torch.ops.affinities import affinity_pipeline
    return (lambda i, d: affinity_pipeline(i, d, PERPLEXITY,
                                           assembly="sorted"),
            _graph(device))


def _mk_blocks(device):
    from tsne_flink_tpu_torch.ops.affinities import affinity_blocks
    return (lambda i, d: affinity_blocks(i, d, PERPLEXITY)), _graph(device)


def _mk_auto(device):
    from tsne_flink_tpu_torch.ops.affinities import affinity_auto
    return (lambda i, d: affinity_auto(i, d, PERPLEXITY)), _graph(device)


def _mk_edges(device):
    from tsne_flink_tpu_torch.ops.affinities import (assemble_edges,
                                                     edge_count)
    jidx, jval = _rows(device)
    return (lambda i, v: assemble_edges(i, v, edge_count(v))), (jidx, jval)


def _mk_plan(device):
    from tsne_flink_tpu_torch.ops.affinities import plan_attraction
    return (lambda i, v: plan_attraction(i, v, "auto")), _rows(device)


def _mk_subsample(device):
    from tsne_flink_tpu_torch.ops.affinities import subsample_affinities
    jidx, jval = _rows(device)
    return subsample_affinities, (jidx, jval, _landmarks(device))


def _mk_placement(device):
    from tsne_flink_tpu_torch.ops.affinities import landmark_placement_rows
    jidx, jval = _rows(device)
    return landmark_placement_rows, (jidx, jval, _landmarks(device))


contract("ops.affinities.affinity_pipeline", _AFF, ("int32", "float32"),
         _mk_pipeline)
contract("ops.affinities.affinity_blocks", _AFF,
         ("int32", "float32", "int32", "int32", "float32"), _mk_blocks)
contract("ops.affinities.affinity_auto", _AFF, ("int32", "float32"),
         _mk_auto)
contract("ops.affinities.assemble_edges", _AFF,
         ("int32", "int32", "float32"), _mk_edges)
# the layout decision: a label and a width, no tensor
contract("ops.affinities.plan_attraction", _AFF, (), _mk_plan)
contract("ops.affinities.subsample_affinities", _AFF, ("int32", "float32"),
         _mk_subsample)
contract("ops.affinities.landmark_placement_rows", _AFF,
         ("int32", "float32"), _mk_placement)


# ---- ops/attraction_cuda.py -------------------------------------------------

_ATT = "tsne_flink_tpu_torch/ops/attraction_cuda.py"


def _mk_ragged(device):
    from tsne_flink_tpu_torch.ops.affinities import (assemble_edges,
                                                     edge_count)
    from tsne_flink_tpu_torch.ops.attraction_cuda import ragged_edges
    jidx, jval = _rows(device)
    src, dst, val = assemble_edges(jidx, jval, edge_count(jval))
    return (lambda s, d, v: ragged_edges(s, d, v, N)), (src, dst, val)


def _mk_build_csr(device):
    from tsne_flink_tpu_torch.ops.affinities import plan_attraction
    from tsne_flink_tpu_torch.ops.attraction_cuda import build_csr
    jidx, jval = _rows(device)
    width = plan_attraction(jidx, jval, "csr")[1]
    return (lambda i, v: build_csr(i, v, width)), (jidx, jval)


def _mk_visit(device):
    from tsne_flink_tpu_torch.ops.attraction_cuda import visit_order
    return visit_order, (_csr(device)[2],)


def _mk_fused(device):
    import torch

    from tsne_flink_tpu_torch.ops.attraction_cuda import fused_step_update
    hidx, hval, ragged = _csr(device)
    y = _y(device)
    rep = _y(device, seed=3)

    def fn(y, rep, upd, gains):
        return fused_step_update(y, y, hidx, hval, 4.0, rep,
                                 torch.ones((), device=y.device), None,
                                 upd, gains, 0.5, eta=100.0, min_gain=0.01,
                                 ragged=ragged)
    return fn, (y, rep, torch.zeros_like(y), torch.ones_like(y))


def _mk_loss(device):
    import torch

    from tsne_flink_tpu_torch.ops.attraction_cuda import attraction_loss
    hidx, hval, ragged = _csr(device)
    return (lambda y: attraction_loss(y, y, hidx, hval, 1.0,
                                      torch.ones((), device=y.device),
                                      ragged=ragged)), (_y(device),)


def _mk_forces(device):
    from tsne_flink_tpu_torch.ops.attraction_cuda import attraction_forces
    hidx, hval, ragged = _csr(device)
    return (lambda y: attraction_forces(y, y, hidx, hval, 1.0,
                                        ragged=ragged)), (_y(device),)


# Ragged: the row pointer (int64), then src, dst, val
contract("ops.attraction_cuda.ragged_edges", _ATT,
         ("int64", "int32", "int32", "float32"), _mk_ragged)
contract("ops.attraction_cuda.build_csr", _ATT,
         ("int32", "float32", "int32", "int32", "float32"), _mk_build_csr)
contract("ops.attraction_cuda.visit_order", _ATT, ("int32",), _mk_visit)
contract("ops.attraction_cuda.fused_step_update", _ATT,
         ("float32",) * 4, _mk_fused)
contract("ops.attraction_cuda.attraction_loss", _ATT, ("float32",),
         _mk_loss)
contract("ops.attraction_cuda.attraction_forces", _ATT, ("float32",),
         _mk_forces)


# ---- ops/repulsion_*.py -----------------------------------------------------

def _mk_exact(device):
    from tsne_flink_tpu_torch.ops.repulsion_cuda import cuda_exact_repulsion
    return (lambda y: cuda_exact_repulsion(y, row_z=True)), (_y(device),)


def _mk_bh(device):
    from tsne_flink_tpu_torch.ops.repulsion_bh import bh_repulsion
    return bh_repulsion, (_y(device),)


def _mk_geometry(device):
    import torch

    from tsne_flink_tpu_torch.ops.repulsion_fft import fft_geometry
    return (lambda: fft_geometry(M, 32, torch.float32, device)), ()


def _mk_fft(device):
    from tsne_flink_tpu_torch.ops.repulsion_fft import fft_repulsion
    return (lambda y: fft_repulsion(y, grid=32)), (_y(device),)


contract("ops.repulsion_cuda.cuda_exact_repulsion",
         "tsne_flink_tpu_torch/ops/repulsion_cuda.py", ("float32",) * 2,
         _mk_exact)
contract("ops.repulsion_bh.bh_repulsion",
         "tsne_flink_tpu_torch/ops/repulsion_bh.py", ("float32",) * 2,
         _mk_bh)
_FFT = "tsne_flink_tpu_torch/ops/repulsion_fft.py"
contract("ops.repulsion_fft.fft_geometry", _FFT, ("float32",), _mk_geometry)
contract("ops.repulsion_fft.fft_repulsion", _FFT, ("float32",) * 2, _mk_fft)
