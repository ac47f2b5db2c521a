"""Mesh-parallel VIO over `torch.distributed`: batched sequences × the
landmark-sharded Schur solve.

Counterpart of `vins_tpu/parallel/sharded.py`.  The ranks of the process
group form a ("seq", "lm") mesh, rank = seq_index · lm + lm_index:

  * `seq` (data parallel): independent windows, a block of the batch per
    row of the mesh;
  * `lm` (model parallel): the landmark axis of each window is split into
    contiguous blocks, one per rank of the row.  Each rank computes its
    projection terms of the cost, of JᵀJ/Jᵀr and of the Schur complement;
    one fused all-reduce per assembly sums them over the row (the
    distributed form of the reference's 4-thread Hessian assembly,
    marginalization_factor.cpp:232-261).  The landmark back-substitution
    stays local, and the marginal prior is a TSQR (solver/marginalize.py).

JAX vmaps the step over a rank's sequences; `torch.func.vmap` cannot batch
a collective, so a rank runs its sequences one after another.  The
all-gather is an all-reduce of a zero-filled buffer: gloo has no all-gather
of CUDA tensors, and a sum with zeros is exact, so every rank receives the
same bits on every backend.  The mesh never falls back to the unsharded
solve: a mesh of one rank runs the same collectives.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..estimator.step import StepResult, make_vio_step
from ..imu.preintegration import ImuNoise
from ..solver import ba as _ba
from ..solver.gn import SolverOptions
from ..solver.problem import FeatureObs, Layout, Prior, WindowState


class Axis:
    """A group of ranks that sum together: what the solver takes in place of
    JAX's mesh-axis name.  `all_reduces` counts the collectives it ran."""

    def __init__(self, group, size: int, index: int):
        self.group, self.size, self.index = group, size, index
        self.all_reduces = 0

    def psum(self, *xs: torch.Tensor) -> tuple:
        """Sum each tensor over the axis, all in one all-reduce of one flat
        buffer (as JAX fuses a tuple psum)."""
        if len({x.dtype for x in xs}) != 1:
            raise TypeError(f"psum of mixed dtypes {[x.dtype for x in xs]}")
        flat = torch.cat([x.reshape(-1) for x in xs])
        dist.all_reduce(flat, group=self.group)
        self.all_reduces += 1
        return tuple(piece.view_as(x) for piece, x in
                     zip(torch.split(flat, [x.numel() for x in xs]), xs))

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[size, *x.shape]: every rank's x, in rank order."""
        buf = x.new_zeros((self.size,) + tuple(x.shape))
        buf[self.index] = x
        return self.psum(buf)[0]


class Mesh:
    """This rank's place in the ("seq", "lm") mesh: `lm_axis` is the rank's
    `lm` row (the window solve's axis), `world` the axis of every rank (the
    sharded BA's)."""

    def __init__(self, seq: int, lm: int, rank: int, lm_axis: Axis, world: Axis):
        self.seq, self.lm = seq, lm
        self.seq_index, self.lm_index = divmod(rank, lm)
        self.lm_axis, self.world = lm_axis, world


def mesh_shape(n: int, seq: int | None = None, lm: int | None = None) -> tuple:
    """(seq, lm) of a mesh of n ranks with JAX's defaults: lm = 2 when n is
    even and above 1, seq = n // lm."""
    if seq is None and lm is None:
        lm = 2 if n % 2 == 0 and n > 1 else 1
        seq = n // lm
    elif seq is None:
        seq = n // lm
    elif lm is None:
        lm = n // seq
    if seq * lm != n:
        raise ValueError(f"a {seq} x {lm} mesh does not cover {n} ranks")
    return seq, lm


def make_mesh(seq: int | None = None, lm: int | None = None) -> Mesh:
    """The ("seq", "lm") mesh over every rank of the initialized default
    process group.  Every rank creates every row's group, in order."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized torch.distributed process group")
    n, rank = dist.get_world_size(), dist.get_rank()
    seq, lm = mesh_shape(n, seq, lm)
    rows = [dist.new_group(list(range(s * lm, (s + 1) * lm))) for s in range(seq)]
    return Mesh(seq, lm, rank, Axis(rows[rank // lm], lm, rank % lm),
                Axis(dist.group.WORLD, n, rank))


def replicated(r: StepResult) -> list:
    """The replicated fields of a step result (all but the inverse depths),
    in a fixed order."""
    return [*r.state, r.prior.J, r.prior.r0, *r.prior.lin, r.prior.valid, r.cost0, r.cost,
            r.fail_imu, r.fail_jump]


def _from_replicated(xs: list) -> StepResult:
    n = len(WindowState._fields)
    state, (J, r0), lin = WindowState(*xs[:n]), xs[n:n + 2], WindowState(*xs[n + 2:2 * n + 2])
    valid, cost0, cost, fail_imu, fail_jump = xs[2 * n + 2:]
    return StepResult(state=state, inv_depth=None, prior=Prior(J, r0, lin, valid),
                      cost0=cost0, cost=cost, fail_imu=fail_imu, fail_jump=fail_jump)


def sequence_args(args: tuple, b: int, ls: slice = slice(None)) -> tuple:
    """The single step's arguments for sequence b of the batched ones, on
    the landmarks `ls` (gravity unbatched, marg_old a Python bool)."""
    state, dt, acc, gyr, mask, obs, tri, prior, gravity, marg_old, last_p = args
    lin = WindowState(*(x[b] for x in prior.lin))
    return (WindowState(*(x[b] for x in state)), dt[b], acc[b], gyr[b], mask[b],
            FeatureObs(*(x[b, ls] for x in obs)), tri[b, ls],
            Prior(prior.J[b], prior.r0[b], lin, prior.valid[b]), gravity, bool(marg_old[b]),
            last_p[b])


def gather_results(local: list, mesh: Mesh, B: int, L: int) -> StepResult:
    """The whole batch's step results on every rank, from each rank's
    results of its own sequences (`local`, inverse depths of its own
    landmark block): one all-reduce over the world of zero-filled global
    buffers, the replicated fields taken from the row's lm rank 0."""
    nb, nl = B // mesh.seq, L // mesh.lm
    b0, l0 = mesh.seq_index * nb, mesh.lm_index * nl
    proto = replicated(local[0])
    dt, dev = local[0].cost.dtype, local[0].cost.device
    sizes = [x.numel() for x in proto]
    rep = torch.zeros((B, sum(sizes)), dtype=dt, device=dev)
    if mesh.lm_index == 0:
        rep[b0:b0 + nb] = torch.stack([torch.cat([x.reshape(-1).to(dt) for x in replicated(r)])
                                       for r in local])
    inv = torch.zeros((B, L), dtype=dt, device=dev)
    inv[b0:b0 + nb, l0:l0 + nl] = torch.stack([r.inv_depth for r in local])
    rep, inv = mesh.world.psum(rep, inv)
    out = [piece.reshape((B,) + x.shape).to(x.dtype) if x.dtype != torch.bool
           else piece.reshape((B,) + x.shape) > 0.5
           for piece, x in zip(torch.split(rep, sizes, dim=1), proto)]
    return _from_replicated(out)._replace(inv_depth=inv)


class ShardedVioStep:
    """The batched multi-sequence VIO step over a ("seq", "lm") mesh (JAX's
    `make_sharded_vio_step`).  Called with the single step's arguments
    (state, imu_dt, imu_acc, imu_gyr, imu_mask, obs, needs_tri, prior,
    gravity, marg_old, last_p), each with a leading batch B divisible by
    `seq` (`gravity` unbatched, `marg_old` [B] bool); the landmark dimension
    L must be divisible by `lm`.  Each rank solves its row's sequences, one
    after another, on its own landmark block; the call returns the whole
    batch's `StepResult` (inverse depths [B, L]) on every rank.  `local` keeps this rank's last
    per-sequence results (its landmark block's inverse depths)."""

    def __init__(self, layout: Layout, noise: ImuNoise, opts: SolverOptions, mesh: Mesh,
                 estimate_extrinsic: bool = False, estimate_td: bool = False):
        self.mesh = mesh
        self.step = make_vio_step(layout, noise, opts, estimate_extrinsic=estimate_extrinsic,
                                  estimate_td=estimate_td, axis_name=mesh.lm_axis)
        self.local: list = []

    def __call__(self, *args) -> StepResult:
        m = self.mesh
        B, L = args[5].valid.shape[:2]
        if B % m.seq or L % m.lm:
            raise ValueError(f"batch {B} and landmarks {L} must divide by the mesh "
                             f"{m.seq} x {m.lm}")
        nb, nl = B // m.seq, L // m.lm
        ls = slice(m.lm_index * nl, (m.lm_index + 1) * nl)
        self.local = [self.step(*sequence_args(args, b, ls))
                      for b in range(m.seq_index * nb, (m.seq_index + 1) * nb)]
        return gather_results(self.local, m, B, L)


def make_sharded_vio_step(layout: Layout, noise: ImuNoise, opts: SolverOptions, mesh: Mesh,
                          estimate_extrinsic: bool = False,
                          estimate_td: bool = False) -> ShardedVioStep:
    """JAX's signature: the batched step sharded over `mesh`."""
    return ShardedVioStep(layout, noise, opts, mesh, estimate_extrinsic, estimate_td)


def make_sharded_ba(mesh: Mesh, iters: int = 10):
    """Distributed visual-only bundle adjustment: landmarks sharded over the
    whole mesh (`mesh.world`), poses replicated.  The returned function
    takes `ba_solve`'s arguments for the whole problem (L divisible by the
    world size) and returns (state with every landmark, cost) on every
    rank; per LM iteration it runs two all-reduces, the cost's and one of
    the four reduced-system terms."""
    axis = mesh.world

    def solve(state: _ba.BAState, obs, valid, fix_pose, fix_pos, pt_mask):
        L = obs.shape[0]
        if L % axis.size:
            raise ValueError(f"{L} landmarks must divide by {axis.size} ranks")
        nl = L // axis.size
        ls = slice(axis.index * nl, (axis.index + 1) * nl)
        st, cost = _ba.ba_solve(state._replace(pts=state.pts[ls]), obs[ls], valid[ls],
                                fix_pose, fix_pos, pt_mask[ls], iters=iters, axis_name=axis)
        pts = state.pts.new_zeros(state.pts.shape)
        pts[ls] = st.pts
        return st._replace(pts=axis.psum(pts)[0]), cost

    return solve
