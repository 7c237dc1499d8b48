"""FFT-accelerated repulsion (port of ``tsne_flink_tpu/ops/repulsion_fft.py``).

The Student-t kernels are translation-invariant, so

    Z      = sum_{i!=j} K1(y_i - y_j),          K1(r) = 1/(1+|r|^2)
    rep_i  = sum_j K2(y_i - y_j) (y_i - y_j),   K2(r) = 1/(1+|r|^2)^2
           = y_i * phi[K2, 1](y_i) - phi[K2, y](y_i)

reduce to kernel convolutions phi[K, w](x) = sum_j K(x - y_j) w_j at the
points (the FIt-SNE construction, Linderman et al.).  Each charge is
spread onto a regular G^m grid through order-p Lagrange interpolation
(:func:`fft_spread`), the grid is convolved with the kernel by FFT in a
circulant embedding of size (2G)^m (:func:`fft_convolve`, with
``torch.fft.rfftn``/``irfftn`` in place of XLA's FFT — the JAX package
has no Pallas kernel here), and the potentials are gathered back at the
points with the same weights (:func:`fft_gather`).  O(N p^m + G^m log G)
per iteration instead of O(N^2): the large-N path.

As in the JAX function: the integer circulant lattice is built once per
optimize run (:func:`fft_geometry`), only the node spacing h follows the
embedding's bounding box; the p^m stencil taps spread as ONE segment sum;
Z is summed spectrally (Parseval over the rfft half-spectrum, the point
count read off the DC bin), with no inverse FFT.

Determinism: the spread is a sorted segment sum — the taps are ordered
by grid cell with a stable sort and each cell is summed in that order by
``torch.segment_reduce`` — not a scatter-add, whose atomics would change
the grid's bits from run to run on the card.

The serving half: a frozen base fixes the bounding box, so the spread
and the convolution of its charges are done once at model load
(:func:`fft_base_field`, an :class:`FftField` of real-space potentials)
and a query batch only gathers them at its positions
(:func:`fft_field_repulsion`, with a per-row Z).
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import torch

#: grid nodes per axis: 1024 keeps the node spacing <= 0.2 for a 2-D
#: embedding spanning ~200 units; 3-D cannot reach that spacing
#: affordably (the JAX package's measured sizing)
DEFAULT_GRID = {2: 1024, 3: 128}


class FftGeom(NamedTuple):
    """Iteration-invariant grid geometry: the squared integer circulant
    lattice ``[2G]^m``, built once per optimize run."""

    rho2: torch.Tensor
    grid: int


class FftStencil(NamedTuple):
    """Each point's interpolation stencil on the grid of one call."""

    base: torch.Tensor   # [N, m] lowest node index of the stencil
    wdim: torch.Tensor   # [N, m, p] Lagrange weights per dim
    h: torch.Tensor      # node spacing (0-d)


def fft_geometry(m: int, grid: int | None = None, dtype=torch.float32,
                 device=None) -> FftGeom:
    g = grid if grid is not None else DEFAULT_GRID.get(m)
    if g is None:
        raise ValueError(f"fft repulsion supports 2 or 3 components, got {m}")
    ar = torch.arange(2 * g, device=device)
    rho = torch.minimum(ar, 2 * g - ar).to(dtype)
    rho2 = torch.zeros((2 * g,) * m, dtype=dtype, device=device)
    for d in range(m):
        shape = [1] * m
        shape[d] = 2 * g
        rho2 = rho2 + rho.reshape(shape) ** 2
    return FftGeom(rho2=rho2, grid=g)


def _lagrange_weights(t: torch.Tensor, p: int) -> torch.Tensor:
    """Lagrange basis values at fractional offset t in [0,1) for p
    equispaced integer nodes -(p-1)//2 .. p-1-(p-1)//2; [..., p]."""
    base = -((p - 1) // 2)
    nodes = [float(base + a) for a in range(p)]
    cols = []
    for a in range(p):
        w = torch.ones_like(t)
        for b in range(p):
            if b != a:
                w = w * (t - nodes[b]) / (nodes[a] - nodes[b])
        cols.append(w)
    return torch.stack(cols, dim=-1)


def fft_stencil(y_full: torch.Tensor, g: int, p: int) -> FftStencil:
    """Bounding box -> node spacing, and every point's stencil base index
    and weights (the index is clipped BEFORE the fractional offset is
    taken, so a boundary point gets its own stencil's weights)."""
    half = (p - 1) // 2
    lo = torch.amin(y_full, dim=0)
    hi = torch.amax(y_full, dim=0)
    side = torch.clamp(torch.amax(hi - lo), min=1e-6)
    h = side / (g - p)  # leaves stencil margin on both sides
    origin = lo - half * h
    u = (y_full - origin[None, :]) / h
    idx0 = torch.clamp(torch.floor(u).to(torch.int32), half, g - p + half)
    frac = u - idx0
    return FftStencil(base=(idx0 - half).long(),
                      wdim=_lagrange_weights(frac, p), h=h)


def _taps(st: FftStencil, g: int, rows=None):
    """(weight [n], flat grid index [n]) of every stencil tap, tap-major
    in ``itertools.product`` order (the JAX function's)."""
    base = st.base if rows is None else st.base[rows]
    wdim = st.wdim if rows is None else st.wdim[rows]
    m, p = wdim.shape[1], wdim.shape[2]
    for offs in itertools.product(range(p), repeat=m):
        w = torch.ones(base.shape[0], dtype=wdim.dtype, device=base.device)
        flat = torch.zeros(base.shape[0], dtype=torch.long,
                           device=base.device)
        for d in range(m):
            w = w * wdim[:, d, offs[d]]
            flat = flat * g + (base[:, d] + offs[d])
        yield w, flat


def fft_spread(y_full: torch.Tensor, st: FftStencil, g: int,
               valid_w: torch.Tensor) -> torch.Tensor:
    """Charges [1, y_0..y_{m-1}] (times validity) spread onto the grid by
    one sorted segment sum over all p^m taps: [nch, G, ..., G]."""
    m = y_full.shape[1]
    charges = torch.cat([valid_w[:, None], y_full * valid_w[:, None]],
                        dim=1)                            # [N, 1+m]
    ws, flats = zip(*_taps(st, g))
    upd = torch.cat([charges * w[:, None] for w in ws])   # [p^m N, nch]
    flat_all = torch.cat(flats)
    order = torch.argsort(flat_all, stable=True)
    lengths = torch.bincount(flat_all, minlength=g ** m)
    grid_ch = torch.segment_reduce(upd[order], "sum", lengths=lengths,
                                   axis=0)                # [G^m, nch]
    return grid_ch.T.reshape((1 + m,) + (g,) * m)


def fft_convolve(gridf: torch.Tensor, geom: FftGeom, h: torch.Tensor):
    """The circulant convolution of every charge channel with K2, and Z:
    ``(pot [nch, G^m], Z)``.  Z comes from the spectrum of the unit
    channel under K1 (Parseval), minus the N self-pairs on the DC bin."""
    nch = gridf.shape[0]
    m = gridf.dim() - 1
    g = geom.grid
    k1 = 1.0 / (1.0 + (h * h) * geom.rho2)
    k2 = k1 * k1
    axes = tuple(range(1, m + 1))
    khat = torch.fft.rfftn(torch.stack([k1, k2]), dim=axes)  # [2, ..., G+1]
    gpad = torch.nn.functional.pad(gridf, (0, g) * m)
    ghat = torch.fft.rfftn(gpad, dim=axes)                   # [nch, ..., G+1]
    # w_k doubles the columns the half-spectrum folds (1 < col < G)
    s0 = ghat[0]
    wcol = torch.full((g + 1,), 2.0, dtype=gridf.dtype, device=gridf.device)
    wcol[0] = 1.0
    wcol[g] = 1.0
    big = float((2 * g) ** m)
    z_pairs = torch.sum((s0.real * s0.real + s0.imag * s0.imag)
                        * khat[0].real * wcol) / big
    n_valid = s0[(0,) * m].real                  # DC bin = total unit charge
    z = (z_pairs - n_valid).to(gridf.dtype)
    conv = torch.fft.irfftn(ghat * khat[1], s=(2 * g,) * m, dim=axes)
    sl = (slice(None),) + tuple(slice(0, g) for _ in range(m))
    return conv[sl].reshape(nch, -1), z


def fft_gather(y: torch.Tensor, pot: torch.Tensor, st: FftStencil, g: int,
               rows: torch.Tensor, y_loc_w: torch.Tensor) -> torch.Tensor:
    """The potentials gathered at the local rows with their spread
    weights: rep [nloc, m] = (y·phi_K2,1 − phi_K2,y) · validity."""
    nch = pot.shape[0]
    phi = torch.zeros((nch, y.shape[0]), dtype=y.dtype, device=y.device)
    for w, flat in _taps(st, g, rows):
        phi = phi + w[None, :] * pot[:, flat]
    return (y * phi[0][:, None] - phi[1:].T) * y_loc_w[:, None]


def fft_repulsion(y: torch.Tensor, y_full: torch.Tensor | None = None, *,
                  grid: int | None = None, interp: int = 3,
                  row_offset: int = 0,
                  col_valid: torch.Tensor | None = None,
                  geom: FftGeom | None = None):
    """Same force contract as ``exact_repulsion``: ``(rep [len(y), m],
    Z)``, with Z the GLOBAL partition sum (a 0-d tensor; not a per-shard
    partial).  ``y`` are rows [row_offset, row_offset + len(y)) of
    ``y_full``; the grid is built from all of ``y_full``.  ``geom`` is the
    hoisted :func:`fft_geometry` (None builds it here)."""
    if y_full is None:
        y_full = y
    nloc, m = y.shape
    if geom is None:
        geom = fft_geometry(m, grid, y.dtype, y.device)
    g = geom.grid
    st = fft_stencil(y_full, g, interp)
    valid_w = (torch.ones(y_full.shape[0], dtype=y.dtype, device=y.device)
               if col_valid is None else col_valid.to(y.dtype))
    pot, z = fft_convolve(fft_spread(y_full, st, g, valid_w), geom, st.h)
    rows = row_offset + torch.arange(nloc, device=y.device)
    rep = fft_gather(y, pot, st, g, rows, valid_w[rows])
    return rep, z


class FftField(NamedTuple):
    """The FROZEN base's repulsion field, precomputed once at model load
    (``serve/model.py``).  ``pot`` holds ``2 + m`` real-space potential
    volumes ``[2+m, G^m]``: row 0 is ``K1 ⊛ 1`` (the per-row partition
    term ``Z_i = Σ_j K1(y_i − y_j)``; queries are not base points, so no
    self-term), row 1 is ``K2 ⊛ 1`` and rows 2.. are ``K2 ⊛ y_d``."""

    pot: torch.Tensor     # [2+m, G^m]
    h: torch.Tensor       # node spacing (0-d)
    origin: torch.Tensor  # [m] grid origin
    grid: int
    interp: int


def fft_base_field(y_base: torch.Tensor, *, grid: int | None = None,
                   interp: int = 3, geom: FftGeom | None = None) -> FftField:
    """Spread + FFT-convolve the frozen base's charges once; returns the
    gatherable :class:`FftField`.  The spectra are build-time transients:
    only the real-space potentials persist."""
    nfull, m = y_base.shape
    if geom is None:
        geom = fft_geometry(m, grid, y_base.dtype, y_base.device)
    g, p = geom.grid, interp
    st = fft_stencil(y_base, g, p)
    ones = torch.ones(nfull, dtype=y_base.dtype, device=y_base.device)
    gridf = fft_spread(y_base, st, g, ones)               # [1+m, G, ...]
    k1 = 1.0 / (1.0 + (st.h * st.h) * geom.rho2)
    axes = tuple(range(1, m + 1))
    khat = torch.fft.rfftn(torch.stack([k1, k1 * k1]), dim=axes)
    ghat = torch.fft.rfftn(torch.nn.functional.pad(gridf, (0, g) * m),
                           dim=axes)
    # the unit charge under K1, then every charge under K2
    chat = torch.cat([ghat[:1] * khat[0], ghat * khat[1]])
    conv = torch.fft.irfftn(chat, s=(2 * g,) * m, dim=axes)
    sl = (slice(None),) + tuple(slice(0, g) for _ in range(m))
    origin = torch.amin(y_base, dim=0) - ((p - 1) // 2) * st.h
    return FftField(pot=conv[sl].reshape(2 + m, -1), h=st.h, origin=origin,
                    grid=g, interp=p)


def fft_field_repulsion(field: FftField, y: torch.Tensor):
    """Repulsion of query rows ``y`` against the frozen base behind
    ``field``: the order-p Lagrange gather of its potentials at the query
    positions, O(B p^m), no FFT and no base traffic.  Returns ``(rep
    [B, m], z_row [B])``, ``z_row`` the per-row partition term.  Positions
    are clamped to the stencil-valid range BEFORE the floor, so a stray's
    fractional offset stays in [0, 1) and it reads the boundary value
    instead of extrapolating."""
    g, p = field.grid, field.interp
    half = (p - 1) // 2
    u = torch.clamp((y - field.origin[None, :]) / field.h, min=float(half),
                    max=g - p + half + 0.999999)
    idx0 = torch.clamp(torch.floor(u).to(torch.int32), half, g - p + half)
    st = FftStencil(base=(idx0 - half).long(),
                    wdim=_lagrange_weights(u - idx0, p), h=field.h)
    phi = torch.zeros((2 + y.shape[1], y.shape[0]), dtype=y.dtype,
                      device=y.device)
    for w, flat in _taps(st, g):
        phi = phi + w[None, :] * field.pot[:, flat]
    return y * phi[1][:, None] - phi[2:].T, phi[0]
