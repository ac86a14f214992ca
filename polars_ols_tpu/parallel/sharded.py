"""Multi-device sharded grouped least squares (mesh + collectives).

The reference's only parallelism is host-local: polars invokes the plugin
once per group on rayon threads (reference README:19; SURVEY §2.3). The
replacement built here scales the *group batch axis* across a
``jax.sharding.Mesh``:

* **Row/data parallelism with moment merging** (`fit_moments_sharded`):
  rows stay wherever they were ingested — each shard computes *partial*
  per-group normal-equation moments (XtX, Xty) for the groups its rows
  touch via one segment-sum, then a single ``psum_scatter``
  merges partials across shards AND scatters the group axis, so every
  device Cholesky-solves an even 1/n slice of groups. A final tiled
  ``all_gather`` replicates coefficients for row-local predictions.
  Because XtX/Xty accumulation is associative, groups spanning shards
  (skew, heavy groups) are merged *exactly* — no row shuffle is needed
  for any moments-based solver (OLS/WLS/ridge; SURVEY §2.3 "DP" row).

* **Group parallelism for whole-group solvers** (`solve_groups_sharded`):
  solvers that need whole groups contiguous (minimum-norm SVD, coordinate
  descent, the RLS/rolling scans) run on the padded ``[G, R, K]`` layout
  with the leading group axis sharded over the mesh — embarrassingly
  parallel, zero collectives after the initial placement.

* **All-to-all row shuffle** (`shuffle_rows_to_groups`): when rows arrive
  data-parallel (distributed ingest) but a whole-group solver is needed,
  one ``lax.all_to_all`` routes every row to its group's home shard and
  assembles the padded layout there, preserving global row order inside
  each group (scan time order).

On one host the cards are joined all to all (NVLink on an H100 host), so
a flat 1-D ``("data",)`` mesh is the layout; the moments path moves only
``[G, K, K]`` moments and ``[G, K]`` coefficients, never the ``[N, K]``
row data, and the shuffle path moves each row exactly once.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
try:
    from jax import shard_map as _shard_map

    def shard_map(f, **kw):
        return _shard_map(f, check_vma=False, **kw)
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map as _shard_map_old

    def shard_map(f, **kw):
        return _shard_map_old(f, check_rep=False, **kw)

from ..ops.linalg import solve_psd, solve_psd_cond

F64 = jnp.float64

# cond(X'X) beyond which the distributed normal-equation solve runs CSNE
# refinement sweeps (matches engine/fit.py's single-device gate)
_COND_REFINE = 1.0e6


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Optional[Sequence[str]] = None,
    shape: Optional[Sequence[int]] = None,
) -> Mesh:
    """Build a device mesh.

    Multi-process (multi-host) runs get a 2-D ``("hosts", "chips")`` mesh by
    construction: the outer axis enumerates processes (its collectives cross
    the network between hosts), the inner axis the devices local to each
    host. Hierarchical reductions over ``("hosts", "chips")`` therefore
    reduce within a host first and exchange only the K x K / K-sized partial
    moments between hosts — the communication layout SURVEY §5's
    distributed-backend row prescribes. Single-process runs, such as one
    host with several GPUs, keep the flat 1-D ``("data",)`` mesh; pass
    ``shape`` + two axis names for an explicit 2-D layout."""
    if axis_names is None:
        n_proc = jax.process_count()
        if n_proc > 1 and n_devices is None and shape is None:
            devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
            local = len(devs) // n_proc
            return Mesh(
                np.asarray(devs).reshape(n_proc, local), ("hosts", "chips")
            )
        axis_names = ("data",)
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    if shape is None:
        shape = (len(devs),) if len(axis_names) == 1 else None
    assert shape is not None, "2-D meshes require an explicit shape"
    return Mesh(np.asarray(devs).reshape(tuple(shape)), tuple(axis_names))


def mesh_row_axes(mesh: Mesh):
    """The axis spec that shards the row/group dimension over EVERY device
    of a mesh (a single name for 1-D meshes, the axis-name tuple for the
    multi-host ('hosts', 'chips') mesh)."""
    names = tuple(mesh.axis_names)
    return names[0] if len(names) == 1 else names


def _linear_axis_index(axes, mesh: Mesh):
    """Flat shard index over one or several mesh axes (row-major)."""
    if isinstance(axes, str):
        return lax.axis_index(axes)
    idx = lax.axis_index(axes[0])
    for a in axes[1:]:
        idx = idx * mesh.shape[a] + lax.axis_index(a)
    return idx


def _mesh_size(mesh: Mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return size


def _pad_to(x: np.ndarray | jnp.ndarray, n: int, axis: int = 0):
    pad = n - x.shape[axis]
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(jnp.asarray(x), widths)


# --------------------------------------------------------------------------- #
# data-parallel moments path (OLS / WLS / ridge over groups)
# --------------------------------------------------------------------------- #
def fit_moments_sharded(
    mesh: Mesh,
    X: jnp.ndarray,  # [N, K] fit features (excluded rows zeroed)
    y: jnp.ndarray,  # [N]
    w: jnp.ndarray,  # [N] bool fit mask
    gids: jnp.ndarray,  # [N] int32/int64 group ids
    num_groups: int,
    alpha: float = 0.0,
    row_axes=None,
    cd_params: Optional[Tuple[float, int, float, bool]] = None,
    X_pred: Optional[jnp.ndarray] = None,
    force_refine: bool = False,
    lu: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Distributed grouped normal-equation (or covariance-form CD) fit.

    Returns (beta [G, K] fully replicated, predictions [N] row-sharded).
    Rows may land on any shard in any order: partial-moment ``psum_scatter``
    merges cross-shard groups exactly (associativity of XtX; SURVEY §2.3).
    ``cd_params = (l1_ratio, max_iter, tol, positive)`` routes the scattered
    per-group moments through covariance-form coordinate descent
    (lasso/elastic-net/NNLS) instead of the Cholesky solve — the iteration
    runs shard-locally on [G/n] groups with zero communication.
    ``X_pred`` supplies the prediction-side features when the null policy
    makes them differ from the fit-side ones (zero-filled full rows).

    The device program is a module-level jit keyed on (mesh, axes, shapes,
    statics) with ``alpha`` a *traced* operand: steady-state queries reuse
    one compiled executable across calls and ridge strengths (eager
    shard_map would re-trace per call; distinct alphas would re-compile).
    """
    if row_axes is None:
        row_axes = mesh_row_axes(mesh)
    if isinstance(row_axes, list):
        row_axes = tuple(row_axes)
    n_shards = _mesh_size(mesh, row_axes)
    N, K = X.shape
    Np = -(-N // n_shards) * n_shards
    Gp = -(-num_groups // n_shards) * n_shards
    Xp = _pad_to(X.astype(F64), Np)
    yp = _pad_to(y.astype(F64), Np)
    wp = _pad_to(w.astype(bool), Np)  # padded rows -> False -> zero moments
    gp = _pad_to(jnp.asarray(gids, dtype=jnp.int32), Np)
    Xpredp = Xp if X_pred is None else _pad_to(X_pred.astype(F64), Np)
    args = (Xp, yp, wp, gp, Xpredp, jnp.asarray(float(alpha), F64))
    statics = dict(
        mesh=mesh, row_axes=row_axes, Gp=Gp, cd_params=cd_params,
        force_refine=force_refine, lu=lu,
    )
    from .introspect import record_program

    record_program("fit_moments", _fit_moments_program, args, statics)
    beta, preds = _fit_moments_program(*args, **statics)
    return beta[:num_groups], preds[:N]


@partial(
    jax.jit,
    static_argnames=("mesh", "row_axes", "Gp", "cd_params", "force_refine", "lu"),
)
def _fit_moments_program(
    Xp, yp, wp, gp, Xpredp, alpha,
    *, mesh: Mesh, row_axes, Gp: int, cd_params, force_refine: bool, lu: bool,
):
    n_shards = _mesh_size(mesh, row_axes)
    K = Xp.shape[1]
    row_spec = P(row_axes)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(row_spec, row_spec, row_spec, row_spec, row_spec, P()),
        out_specs=(P(), row_spec),
    )
    def step(Xl, yl, wl, gl, Xpl, alpha):
        wf = wl.astype(F64)
        Xm = Xl * wf[:, None]
        # local partial moments for ALL groups (rows of other shards add 0)
        xtx = jax.ops.segment_sum(
            jnp.einsum("nk,nl->nkl", Xm, Xl, preferred_element_type=F64),
            gl,
            num_segments=Gp,
        )
        xty = jax.ops.segment_sum(Xm * yl[:, None], gl, num_segments=Gp)
        counts = jax.ops.segment_sum(wf, gl, num_segments=Gp)
        # merge partials across shards + scatter the group axis in one op
        xtx = lax.psum_scatter(xtx, row_axes, scatter_dimension=0, tiled=True)
        xty = lax.psum_scatter(xty, row_axes, scatter_dimension=0, tiled=True)
        if cd_params is not None:
            from ..ops.cd import solve_elastic_net_cov

            counts = lax.psum_scatter(counts, row_axes, scatter_dimension=0, tiled=True)
            l1_ratio, max_iter, tol, positive = cd_params[:4]
            active_set = bool(cd_params[4]) if len(cd_params) > 4 else False
            beta_local = solve_elastic_net_cov(
                xtx, xty, counts, alpha=alpha, l1_ratio=l1_ratio,
                max_iter=max_iter, tol=tol, positive=positive,
                active_set=active_set,
            )
        else:
            A = xtx + jnp.asarray(alpha, F64) * jnp.eye(K, dtype=F64)

            def refine(b):
                # distributed CSNE sweeps (see engine/fit.py): the residual
                # row pass is shard-local, X'r partials psum_scatter-merge;
                # the local normal matrix factors once for all sweeps
                from ..ops.linalg import psd_solver

                solve = psd_solver(A)
                for _ in range(4):
                    bg = lax.all_gather(b, row_axes, axis=0, tiled=True)
                    resid = (
                        yl - jnp.einsum("nk,nk->n", Xl, jnp.take(bg, gl, axis=0))
                    ) * wf
                    Xtr = lax.psum_scatter(
                        jax.ops.segment_sum(
                            Xl * resid[:, None], gl, num_segments=Gp
                        ),
                        row_axes, scatter_dimension=0, tiled=True,
                    )
                    b = b + solve(Xtr - jnp.asarray(alpha, F64) * b)
                return b

            if lu:
                # explicit 'lu': the genuine partial-pivot kernel, matching
                # the single-device path (no CSNE — plain factorization)
                from ..ops.linalg import solve_lu

                beta_local = solve_lu(A, xty)
            elif force_refine:
                # explicit 'qr': unconditional CSNE sweeps so the sharded
                # path matches the single-device CholeskyQR2-equivalent
                beta_local = refine(solve_psd(A, xty))
            else:
                beta_local, cond_est = solve_psd_cond(A, xty)  # [Gp / n, K]
                need = lax.pmax(jnp.max(cond_est), row_axes) > _COND_REFINE
                beta_local = lax.cond(need, refine, lambda b: b, beta_local)
        beta = lax.all_gather(beta_local, row_axes, axis=0, tiled=True)
        preds = jnp.einsum("nk,nk->n", Xpl, jnp.take(beta, gl, axis=0))
        return beta, preds

    return step(Xp, yp, wp, gp, Xpredp, alpha)


def statistics_moments_sharded(
    mesh: Mesh,
    X: jnp.ndarray,  # [N, K] fit features (excluded rows zeroed)
    y: jnp.ndarray,  # [N]
    w: jnp.ndarray,  # [N] bool fit mask
    gids: jnp.ndarray,  # [N]
    num_groups: int,
    alpha: float = 0.0,
    row_axes=None,
    cd_params: Optional[Tuple[float, int, float, bool]] = None,
):
    """Distributed mode='statistics': moments merge with psum_scatter, each
    shard solves + computes feature metrics for its 1/n slice of groups,
    per-row residual partials (RSS/SAE/SST from *rows*, not moment
    identities) psum-merge, and the finished [G]-shaped metric arrays are
    all_gathered back. Returns a dict of replicated [G(,K)] arrays.

    With ``cd_params`` the reported coefficients and residual metrics come
    from shard-local covariance-form coordinate descent (lasso/enet/NNLS)
    while se/t/p keep the normal-equation recompute — mirroring the
    single-device `_blocks_statistics_kernel` and the reference's
    src/statistics.rs:116 semantics."""
    if row_axes is None:
        row_axes = mesh_row_axes(mesh)
    if isinstance(row_axes, list):
        row_axes = tuple(row_axes)
    n_shards = _mesh_size(mesh, row_axes)
    N, K = X.shape
    Np = -(-N // n_shards) * n_shards
    Gp = -(-num_groups // n_shards) * n_shards
    Xp = _pad_to(X.astype(F64), Np)
    yp = _pad_to(y.astype(F64), Np)
    wp = _pad_to(w.astype(bool), Np)
    gp = _pad_to(jnp.asarray(gids, dtype=jnp.int32), Np)
    args = (Xp, yp, wp, gp, jnp.asarray(float(alpha), F64))
    statics = dict(
        mesh=mesh, row_axes=row_axes, Gp=Gp, cd_params=cd_params,
        ridge=float(alpha) > 0.0,
    )
    from .introspect import record_program

    record_program("statistics_moments", _statistics_moments_program, args, statics)
    beta, rss, sae, sst, counts, se, tv, pv = _statistics_moments_program(
        *args, **statics
    )
    n_safe = jnp.maximum(counts, 1.0)
    sl = slice(None, num_groups)
    return {
        "coefficients": beta[sl],
        "mse": (rss / n_safe)[sl],
        "mae": (sae / n_safe)[sl],
        "r2": (1.0 - rss / sst)[sl],
        "standard_errors": se[sl],
        "t_values": tv[sl],
        "p_values": pv[sl],
    }


@partial(
    jax.jit,
    static_argnames=("mesh", "row_axes", "Gp", "cd_params", "ridge"),
)
def _statistics_moments_program(
    Xp, yp, wp, gp, alpha,
    *, mesh: Mesh, row_axes, Gp: int, cd_params, ridge: bool,
):
    from ..ops.statistics import feature_metrics

    n_shards = _mesh_size(mesh, row_axes)
    K = Xp.shape[1]
    row_spec = P(row_axes)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(row_spec, row_spec, row_spec, row_spec, P()),
        out_specs=P(),
    )
    def step(Xl, yl, wl, gl, alpha):
        wf = wl.astype(F64)
        Xm = Xl * wf[:, None]
        xtx = jax.ops.segment_sum(
            jnp.einsum("nk,nl->nkl", Xm, Xl, preferred_element_type=F64),
            gl, num_segments=Gp,
        )
        xty = jax.ops.segment_sum(Xm * yl[:, None], gl, num_segments=Gp)
        counts = lax.psum(
            jax.ops.segment_sum(wf, gl, num_segments=Gp), row_axes
        )
        sumy = lax.psum(
            jax.ops.segment_sum(yl * wf, gl, num_segments=Gp), row_axes
        )
        xtx_s = lax.psum_scatter(xtx, row_axes, scatter_dimension=0, tiled=True)
        xty_s = lax.psum_scatter(xty, row_axes, scatter_dimension=0, tiled=True)
        idx0 = _linear_axis_index(row_axes, mesh) * (Gp // n_shards)
        counts_s = lax.dynamic_slice_in_dim(counts, idx0, Gp // n_shards)
        A = xtx_s + jnp.asarray(alpha, F64) * jnp.eye(K, dtype=F64)
        beta_ne_local = solve_psd(A, xty_s)
        if cd_params is not None:
            from ..ops.cd import solve_elastic_net_cov

            l1_ratio, max_iter, tol, positive = cd_params[:4]
            active_set = bool(cd_params[4]) if len(cd_params) > 4 else False
            beta_local = solve_elastic_net_cov(
                xtx_s, xty_s, counts_s, alpha=alpha, l1_ratio=l1_ratio,
                max_iter=max_iter, tol=tol, positive=positive,
                active_set=active_set,
            )
        else:
            beta_local = beta_ne_local
        beta = lax.all_gather(beta_local, row_axes, axis=0, tiled=True)  # [Gp, K]
        # per-row residual partials with the replicated beta
        resid = (yl - jnp.einsum("nk,nk->n", Xl, jnp.take(beta, gl, axis=0))) * wf
        rss = lax.psum(
            jax.ops.segment_sum(resid * resid, gl, num_segments=Gp), row_axes
        )
        sae = lax.psum(
            jax.ops.segment_sum(jnp.abs(resid), gl, num_segments=Gp), row_axes
        )
        n_safe = jnp.maximum(counts, 1.0)
        mean = sumy / n_safe
        dev = (yl - jnp.take(mean, gl, axis=0)) * wf
        sst = lax.psum(
            jax.ops.segment_sum(dev * dev, gl, num_segments=Gp), row_axes
        )
        if cd_params is not None:
            # se/t/p derive from the normal-equation RSS (the reference
            # recomputes beta from the normal equations, statistics.rs:116)
            beta_ne = lax.all_gather(beta_ne_local, row_axes, axis=0, tiled=True)
            resid_ne = (
                yl - jnp.einsum("nk,nk->n", Xl, jnp.take(beta_ne, gl, axis=0))
            ) * wf
            rss_ne = lax.psum(
                jax.ops.segment_sum(resid_ne * resid_ne, gl, num_segments=Gp),
                row_axes,
            )
        else:
            rss_ne = rss
        rss_s = lax.dynamic_slice_in_dim(rss_ne, idx0, Gp // n_shards)
        fm = feature_metrics(xtx_s, xty_s, rss_s, counts_s, alpha, ridge=ridge)
        gath = lambda a: lax.all_gather(a, row_axes, axis=0, tiled=True)
        return (
            beta,
            rss,
            sae,
            sst,
            counts,
            gath(fm["standard_errors"]),
            gath(fm["t_values"]),
            gath(fm["p_values"]),
        )

    return step(Xp, yp, wp, gp, alpha)


# --------------------------------------------------------------------------- #
# group-parallel path (whole-group solvers: SVD / CD / scans)
# --------------------------------------------------------------------------- #
def shard_group_axis(mesh: Mesh, arrays, group_axes=None):
    """Place ``[G, ...]`` padded-group arrays with G sharded over the mesh.

    G is padded up to a multiple of the mesh size; callers slice results
    back to the true G. Returns (placed_arrays, true_G).
    """
    if group_axes is None:
        group_axes = mesh_row_axes(mesh)
    n_shards = _mesh_size(mesh, group_axes)
    G = arrays[0].shape[0]
    Gp = -(-G // n_shards) * n_shards
    spec = P(group_axes)
    placed = []
    for a in arrays:
        ap = _pad_to(a, Gp)
        placed.append(jax.device_put(ap, NamedSharding(mesh, spec)))
    return placed, G


def shuffle_rows_to_groups(
    mesh: Mesh,
    X: jnp.ndarray,  # [N, K]
    y: jnp.ndarray,  # [N]
    w: jnp.ndarray,  # [N] bool validity (invalid rows keep their position)
    gids: jnp.ndarray,  # [N] int group ids
    num_groups: int,
    row_axes=None,
    rows_per_group: Optional[int] = None,
    capacity: Optional[int] = None,
):
    """Device-side all-to-all shuffle of rows to group-home shards.

    The whole-group solvers (scans, minimum-norm SVD, coordinate descent)
    need each group's rows contiguous on one shard. When rows arrive
    data-parallel (block-sharded in ingest order), this routes them with ONE
    ``lax.all_to_all`` — the hash-shuffle communication pattern SURVEY §2.3
    / §5 name for the distributed backend — and assembles the standard
    padded ``[G, R]`` whole-group layout on the receiving shards, rows
    ordered by global row index (time order, as the RLS/rolling scans
    require; reference analog: polars' own row dispatch into per-group
    plugin calls, README:19).

    Group ``g``'s home shard is ``g // (G_padded / n_shards)`` — the same
    block assignment ``psum_scatter(scatter_dimension=0, tiled=True)``
    produces, so moments-path and shuffle-path shards agree.

    Returns ``(Xg [Gp, R, K], yg [Gp, R], vg [Gp, R] bool, G)`` with the
    leading group axis sharded over ``row_axes``; padding slots have
    ``vg=False`` and zeroed values. ``rows_per_group`` / ``capacity``
    (max rows any single (src shard → dest shard) pair exchanges) are
    computed exactly from host-visible gids by default; a true multi-process
    ingest, where no host sees all gids, must supply both explicitly — the
    shuffle program itself is pure device collectives.
    """
    if row_axes is None:
        row_axes = mesh_row_axes(mesh)
    n = _mesh_size(mesh, row_axes)
    N, K = X.shape
    Np = -(-N // n) * n
    L = Np // n  # rows per shard
    Gp = -(-num_groups // n) * n
    gps = Gp // n  # groups per shard

    g_host = np.asarray(gids, dtype=np.int64)
    dest_host = g_host // gps
    src_host = np.arange(N, dtype=np.int64) // L
    pair_max = int(np.bincount(src_host * n + dest_host, minlength=n * n).max())
    if capacity is None:
        from ..engine.groups import bucket_size

        capacity = bucket_size(max(pair_max, 1))
    elif capacity < pair_max:
        # a too-small bucket would silently drop rows on the send side
        raise ValueError(
            f"shuffle capacity {capacity} < max rows a single src->dest "
            f"shard pair exchanges ({pair_max})"
        )
    rows_max = int(np.bincount(g_host, minlength=num_groups).max())
    if rows_per_group is None:
        from ..engine.groups import bucket_size

        rows_per_group = bucket_size(max(rows_max, 1))
    elif rows_per_group < rows_max:
        raise ValueError(
            f"rows_per_group {rows_per_group} < largest group ({rows_max})"
        )
    C, R = int(capacity), int(rows_per_group)

    Xp = _pad_to(X.astype(F64), Np)
    yp = _pad_to(y.astype(F64), Np)
    wp = _pad_to(w.astype(bool), Np)
    gp = _pad_to(jnp.asarray(gids, dtype=jnp.int32), Np)
    # present=0 marks N..Np padding; real rows carry their global index so
    # the receiving shard can restore time order within each group
    present = (jnp.arange(Np) < N).astype(F64)
    ridx = jnp.arange(Np, dtype=F64)
    if isinstance(row_axes, list):
        row_axes = tuple(row_axes)
    args = (Xp, yp, wp, gp, present, ridx)
    statics = dict(mesh=mesh, row_axes=row_axes, Gp=Gp, C=C, R=R)
    from .introspect import record_program

    record_program("shuffle_rows", _shuffle_program, args, statics)
    Xg, yg, vg = _shuffle_program(*args, **statics)
    return Xg, yg, vg, num_groups


@partial(
    jax.jit,
    static_argnames=("mesh", "row_axes", "Gp", "C", "R"),
)
def _shuffle_program(
    Xp, yp, wp, gp, present, ridx,
    *, mesh: Mesh, row_axes, Gp: int, C: int, R: int,
):
    """The shuffle's device program, cached per (mesh, axes, shapes,
    capacity, rows_per_group) like the moments programs — repeated
    distributed-ingest calls reuse one executable."""
    n = _mesh_size(mesh, row_axes)
    Np, K = Xp.shape
    L = Np // n
    gps = Gp // n
    row_spec = P(row_axes)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(row_spec,) * 6,
        out_specs=(row_spec, row_spec, row_spec),
    )
    def step(Xl, yl, wl, gl, pl, il):
        # ---- send side: bucket local rows by destination shard ----
        dest = jnp.where(pl > 0, gl.astype(jnp.int64) // gps, n)  # pad -> n
        order = jnp.argsort(dest, stable=True)  # global order kept per dest
        dsort = jnp.take(dest, order)
        cnt = jax.ops.segment_sum(jnp.ones(L, F64), dsort, num_segments=n + 1)
        first = jnp.concatenate(
            [jnp.zeros(1, F64), jnp.cumsum(cnt)[:-1]]
        ).astype(jnp.int64)
        pos = jnp.arange(L, dtype=jnp.int64) - jnp.take(first, dsort)
        # packed row record: [present, ridx, gid, w, y, X...]
        rec = jnp.concatenate(
            [
                jnp.take(pl, order)[:, None],
                jnp.take(il, order)[:, None],
                jnp.take(gl, order).astype(F64)[:, None],
                jnp.take(wl, order).astype(F64)[:, None],
                jnp.take(yl, order)[:, None],
                jnp.take(Xl, order, axis=0),
            ],
            axis=1,
        )
        buf = jnp.zeros((n, C, K + 5), F64)
        ok = (dsort < n) & (pos < C)
        # not-ok rows scatter out of bounds and are dropped (never clamp to a
        # real slot: a duplicate-index write could clobber a genuine row)
        buf = buf.at[jnp.where(ok, dsort, n), jnp.where(ok, pos, C)].set(
            rec, mode="drop"
        )
        # ---- the one collective: block j of buf -> shard j ----
        recv = lax.all_to_all(
            buf, row_axes, split_axis=0, concat_axis=0, tiled=True
        ).reshape(n * C, K + 5)
        # ---- receive side: assemble the padded [gps, R] group layout ----
        here = recv[:, 0] > 0
        lg = jnp.where(
            here, recv[:, 2].astype(jnp.int64) - _linear_axis_index(row_axes, mesh) * gps, gps
        )
        # sort by (local group, global row index): per-group runs in time order
        key = lg.astype(F64) * (Np + 1) + jnp.where(here, recv[:, 1], 0.0)
        r_order = jnp.argsort(key, stable=True)
        lgs = jnp.take(lg, r_order)
        rcnt = jax.ops.segment_sum(
            jnp.ones(n * C, F64), lgs, num_segments=gps + 1
        )
        rfirst = jnp.concatenate(
            [jnp.zeros(1, F64), jnp.cumsum(rcnt)[:-1]]
        ).astype(jnp.int64)
        rpos = jnp.arange(n * C, dtype=jnp.int64) - jnp.take(rfirst, lgs)
        rrec = jnp.take(recv, r_order, axis=0)
        rok = (lgs < gps) & (rpos < R) & (rrec[:, 0] > 0)
        sg = jnp.where(rok, lgs, gps)  # out of bounds -> dropped
        sp = jnp.where(rok, rpos, R)
        Xg = jnp.zeros((gps, R, K), F64).at[sg, sp].set(rrec[:, 5:], mode="drop")
        yg = jnp.zeros((gps, R), F64).at[sg, sp].set(rrec[:, 4], mode="drop")
        vg = jnp.zeros((gps, R), bool).at[sg, sp].set(
            rrec[:, 3] > 0, mode="drop"
        )
        return Xg, yg, vg

    return step(Xp, yp, wp, gp, present, ridx)


def solve_groups_sharded(mesh: Mesh, solver, arrays, group_axes=None, **solver_kwargs):
    """Run a batched whole-group solver with the group axis sharded.

    ``solver(*arrays, **solver_kwargs)`` must be vmapped/batched over the
    leading group axis (all of ops.direct / ops.cd / ops.recursive /
    ops.rolling qualify). XLA partitions the batch across the mesh with no
    communication — the device analog of the reference's per-group rayon
    dispatch.
    """
    if group_axes is None:
        group_axes = mesh_row_axes(mesh)
    placed, G = shard_group_axis(mesh, arrays, group_axes)
    fn = _group_solver_program(
        solver, tuple(sorted(solver_kwargs.items())),
        NamedSharding(mesh, P(group_axes)),
    )
    from .introspect import record_program

    record_program("groups_sharded", fn, tuple(placed), {})
    out = fn(*placed)
    return out[:G]


@lru_cache(maxsize=64)
def _group_solver_program(solver, kwargs_items, out_shardings):
    """One jitted program per (solver, kwargs, sharding): a fresh
    ``jax.jit`` per query would trace and lower the solver on every call."""
    return jax.jit(partial(solver, **dict(kwargs_items)), out_shardings=out_shardings)
