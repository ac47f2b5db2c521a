"""The landmark-sharded window solve over `torch.distributed`: one rank of
a ("seq", "lm") mesh per process.

Counterpart of `tools/bench_scaling.py` and `__graft_entry__.dryrun_multichip`
of the JAX package.  Each rank builds the same inputs (`sim/window.py`, a
distinct window problem per `seq` shard, seeds 17 + s, perturbed with
seeds 1 + s, as the dryrun), runs the sharded VIO step
(`parallel/sharded.py`) in each `--dtype` at `--frames` × each of
`--landmarks`, with `marg_old` true and false, and the sharded BA in
float64 at `--frames` × `--ba-landmarks`, and holds both against the one-rank solve on the same
device (rank 0).  Rank 0 prints one JSON line: costs, the largest
differences, ms per sharded step and per BA iteration beside the one-rank
solve, the all-reduces per LM iteration, whether every replicated output is
bitwise equal across the ranks that share it, and, on CUDA, the device
kernels and busy ms of one rank's sharded step.  It exits non-zero when a
bound is missed.

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        -m vins_tpu_torch.run_sharded [--backend nccl|gloo] [--seq S] [--lm M] \\
        [--dtype float64[,float32]] [--device cuda|cpu] [--landmarks 1024[,256]] \\
        [--ba-landmarks 4096] [--frames 11]

With `--inputs FILE.npz --out DIR` a rank instead runs the problems stored
in the file (written by `save_inputs`: a batched step under `step/`, a BA
under `ba/`, a JᵀJ reduction under `jtj/`, any of them) and writes its
results to DIR/rank{r}.npz.  `launch` starts N ranks as processes with the
environment that `torch.distributed.run` gives them, each with a time limit,
and kills them all when one fails.  Several ranks can share one card under
gloo (NCCL refuses two ranks on one GPU); then the times are of ranks
sharing the card, not a scaling result.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from .core import lie
from .estimator.step import StepResult, make_vio_step
from .imu.preintegration import ImuNoise
from .parallel.sharded import (Mesh, make_mesh, make_sharded_ba, make_sharded_vio_step,
                               replicated, sequence_args)
from .sim.window import build_window_problem, perturb_state
from .solver.ba import BAState, ba_solve
from .solver.gn import SolverOptions
from .solver.problem import FeatureObs, Layout, Prior, WindowState

TIMEOUT_S = 60  # of every collective
REPS = 3  # timed calls of each function (median)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the bounds of tests/test_parallel.py (float64) and the float32 bound of
# the batched-against-single step (relative to the largest entry)
F64 = dict(p=1e-8, inv_depth=1e-8, cost_rel=1e-9, prior_atol=1e-5, prior_rtol=1e-4,
           ba_cost_rel=1e-8, ba_p=1e-8, ba_pts=1e-7)
F32_STATE_REL = 1e-4
STEP_ARGS = ("state", "imu_dt", "imu_acc", "imu_gyr", "imu_mask", "obs", "needs_tri", "prior",
             "gravity", "marg_old", "last_p")
BA_ARGS = ("state", "obs", "valid", "fix_pose", "fix_pos", "pt_mask")
TYPES = {"state": WindowState, "obs": FeatureObs, "prior": Prior}


# ---- inputs ------------------------------------------------------------------

def _rebuild(like: tuple, values):
    return type(like)(*values) if hasattr(like, "_fields") else tuple(values)


def stack(items):
    """Stack a list of (nested tuples of) tensors along a new axis 0."""
    if isinstance(items[0], tuple):
        return _rebuild(items[0], (stack(list(xs)) for xs in zip(*items)))
    return torch.stack([torch.as_tensor(x) for x in items])


def step_inputs(B: int, frames: int, L: int, dtype, device) -> tuple:
    """The batched step's arguments: window problem s (seed 17 + s) from its
    true states perturbed with seed 1 + s, an empty prior, nothing to
    triangulate, as `__graft_entry__.dryrun_multichip`'s (marg_old true)."""
    layout = Layout(frames)
    per = []
    for s in range(B):
        prob = build_window_problem(frames, L, seed=17 + s, dtype=dtype, device=device)
        per.append((perturb_state(prob.state_true, 1 + s, pos_sigma=0.02, rot_sigma=0.01),
                    prob.raw_dt, prob.raw_acc, prob.raw_gyr, prob.raw_mask.to(dtype), prob.obs,
                    torch.zeros(L, dtype=torch.bool, device=device),
                    Prior.empty(layout, dtype, device), prob.gravity,
                    torch.tensor(True, device=device), prob.state_true.p[-1]))
    batch = stack(per)
    return batch[:8] + (per[0][8],) + batch[9:]


def ba_inputs(frames: int, L: int, dtype, device) -> tuple:
    """`ba_solve`'s arguments for the camera-frame BA of a window scene (the
    problem of tests/test_parallel.py and tools/bench_scaling.py): camera
    positions and points perturbed by 0.02 / 0.05 m (a generator seeded 5),
    pose 0 fixed, the positions of the first and last frames fixed."""
    prob = build_window_problem(frames, L, seed=0, dtype=torch.float64, device="cpu")
    st = prob.state_true
    gen = torch.Generator().manual_seed(5)
    p_c = st.p + lie.qrotate(st.q, st.tic)
    state = BAState(p=p_c + 0.02 * torch.randn(p_c.shape, generator=gen, dtype=torch.float64),
                    q=lie.qmul(st.q, st.qic),
                    pts=prob.points + 0.05 * torch.randn(prob.points.shape, generator=gen,
                                                         dtype=torch.float64))
    valid = prob.obs.valid
    fix_pose = torch.arange(frames) == 0
    fix_pos = fix_pose | (torch.arange(frames) == frames - 1)
    args = (state, prob.obs.pt, valid, fix_pose, fix_pos, valid.sum(1) >= 2)
    return to(args, dtype, device)


def to(x, dtype, device):
    """(Nested tuples of) tensors onto `device`, floats in `dtype`."""
    if isinstance(x, tuple):
        return _rebuild(x, (to(v, dtype, device) for v in x))
    return x.to(device=device, dtype=dtype if x.is_floating_point() else x.dtype)


def flatten(prefix: str, x, out: dict) -> dict:
    """A nested NamedTuple of tensors as {prefix/field/...: numpy array}."""
    if isinstance(x, tuple):
        for name, v in zip(x._fields, x):
            flatten(f"{prefix}/{name}", v, out)
    elif x is not None:
        out[prefix] = torch.as_tensor(x).detach().cpu().numpy()
    return out


def unflatten(cls, prefix: str, d, device):
    """`flatten`'s inverse for a NamedTuple type (a `Prior`'s `lin` nested)."""
    return cls(*(unflatten(WindowState, f"{prefix}/{f}", d, device) if f == "lin"
                 else torch.from_numpy(d[f"{prefix}/{f}"]).to(device) for f in cls._fields))


def save_inputs(path: str, step=None, ba=None, iters: int = 8, ba_iters: int = 8,
                jtj=None) -> None:
    """Write problems for `--inputs`: `step` the batched step's arguments
    (STEP_ARGS, numpy or tensors), `ba` `ba_solve`'s (BA_ARGS), `jtj` a
    pair (J [L, D], r [L]) to reduce."""
    d = {}
    if step is not None:
        for name, v in zip(STEP_ARGS, step):
            flatten(f"step/{name}", v, d)
        d["step/iters"] = np.asarray(iters)
    if ba is not None:
        for name, v in zip(BA_ARGS, ba):
            flatten(f"ba/{name}", v, d)
        d["ba/iters"] = np.asarray(ba_iters)
    if jtj is not None:
        d["jtj/J"], d["jtj/r"] = (np.asarray(x) for x in jtj)
    np.savez(path, **d)


def load_inputs(d, device):
    out = {}
    if "step/iters" in d:
        step = [unflatten(TYPES[n], f"step/{n}", d, device) if n in TYPES
                else torch.from_numpy(d[f"step/{n}"]).to(device) for n in STEP_ARGS]
        obs = step[STEP_ARGS.index("obs")]
        step[STEP_ARGS.index("obs")] = obs._replace(anchor=obs.anchor.long())
        out["step"] = tuple(step)
        out["step_iters"] = int(d["step/iters"])
    if "ba/iters" in d:
        out["ba"] = tuple(unflatten(BAState, "ba/state", d, device) if n == "state"
                          else torch.from_numpy(d[f"ba/{n}"]).to(device) for n in BA_ARGS)
        out["ba_iters"] = int(d["ba/iters"])
    return out


# ---- one rank --------------------------------------------------------------------

def init(backend: str, device: str) -> torch.device:
    """Join the process group from the environment `torch.distributed.run`
    sets (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK)."""
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda, but no CUDA device is visible")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method="env://",
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return dev


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def barrier(dev) -> None:
    dist.barrier()
    sync(dev)


def replicated_equal(local: list, mesh: Mesh) -> bool:
    """Whether, in every row of the mesh, the lm ranks hold bitwise the same
    replicated outputs of their sequences: each row gathers its copies and
    compares them bit for bit, and the rows' verdicts are summed over the
    world, so every rank returns the whole mesh's answer."""
    flat = torch.cat([x.reshape(-1).double() for r in local for x in replicated(r)])
    copies = mesh.lm_axis.all_gather(flat)
    differs = float(not all(torch.equal(copies[0], c) for c in copies[1:]))
    return float(mesh.world.psum(flat.new_tensor([differs]))[0][0]) == 0


def profiled(fn) -> dict:
    """fn() under torch.profiler: its device kernels and busy ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time for e in kernels) / 1e3
    return dict(device_kernels=len(kernels), device_busy_ms=busy, wall_ms_profiled=wall)


def timed(fn, dev) -> float:
    """Median host ms of REPS calls of fn(), the device synchronized around each."""
    ts = []
    for _ in range(REPS):
        sync(dev)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def compare_step(out: StepResult, refs: list, dtype) -> dict:
    """The sharded results against the one-rank ones, sequence by
    sequence: the largest differences and whether the bounds hold."""
    d = dict(max_dp=0.0, max_dinv_depth=0.0, cost_rel=0.0, prior_jtj_rel=0.0, state_rel=0.0)
    ok = True
    for b, ref in enumerate(refs):
        dp = float((out.state.p[b] - ref.state.p).abs().max())
        di = float((out.inv_depth[b] - ref.inv_depth).abs().max())
        cr = rel(out.cost[b], ref.cost)
        Hs, Hr = out.prior.J[b].T @ out.prior.J[b], ref.prior.J.T @ ref.prior.J
        scale = float(Hr.abs().max())
        prior_ok = bool(torch.all((Hs - Hr).abs() <= F64["prior_atol"] * scale
                                  + F64["prior_rtol"] * Hr.abs()))
        sr = max(rel(getattr(out.state, f)[b], getattr(ref.state, f)) for f in ("p", "q", "v"))
        fin = all(bool(torch.isfinite(x[b]).all()) for x in (*out.state, out.cost))
        d = dict(max_dp=max(d["max_dp"], dp), max_dinv_depth=max(d["max_dinv_depth"], di),
                 cost_rel=max(d["cost_rel"], cr), state_rel=max(d["state_rel"], sr),
                 prior_jtj_rel=max(d["prior_jtj_rel"], rel(Hs, Hr)))
        if dtype == torch.float64:
            ok &= dp <= F64["p"] and di <= F64["inv_depth"] and cr <= F64["cost_rel"] and prior_ok
        else:
            ok &= fin and sr <= F32_STATE_REL
    d["cost"] = [float(c) for c in out.cost]
    d["within_bounds"] = bool(ok)
    return d


def run_vio(mesh, dev, args: tuple, marg_old: bool, profile: bool) -> dict:
    """The sharded step on `step_inputs`' arguments with every sequence's
    marg_old set to `marg_old`, held against the one-rank step."""
    state, obs = args[0], args[5]
    frames, L, dtype = state.p.shape[1], obs.valid.shape[1], state.p.dtype
    args = args[:9] + (torch.full_like(args[9], marg_old),) + args[10:]
    layout, noise = Layout(frames), ImuNoise()
    sharded = make_sharded_vio_step(layout, noise, SolverOptions(iters=8), mesh)
    # all-reduces per LM iteration: a step at 8 iterations against one at 1
    counts = []
    for fn in (make_sharded_vio_step(layout, noise, SolverOptions(iters=1), mesh), sharded):
        n0 = mesh.lm_axis.all_reduces
        out = fn(*args)
        counts.append(mesh.lm_axis.all_reduces - n0)
    equal = replicated_equal(sharded.local, mesh)
    barrier(dev)
    ms = timed(lambda: sharded(*args), dev)
    rec = dict(dtype=str(dtype)[6:], landmarks=L, marg_old=marg_old, sequences=mesh.seq,
               ms_sharded_step=ms,
               all_reduces_per_step=counts[1],
               all_reduces_per_lm_iteration=(counts[1] - counts[0]) / 7,
               replicas_bitwise_equal=equal)
    if profile and dev.type == "cuda":
        prof = {}
        if mesh.world.index == 0:
            prof = profiled(lambda: sharded(*args))
        else:
            sharded(*args)
        rec["profile_rank0"] = prof or None
    barrier(dev)
    if mesh.world.index == 0:
        single = make_vio_step(layout, noise, SolverOptions(iters=8))
        refs = [single(*sequence_args(args, b)) for b in range(mesh.seq)]
        rec.update(compare_step(out, refs, dtype))
        rec["ms_single_step"] = timed(lambda: single(*sequence_args(args, 0)), dev)
    barrier(dev)
    return rec


def run_ba(mesh, dev, frames: int, L: int, iters: int = 8) -> dict:
    args = ba_inputs(frames, L, torch.float64, dev)
    counts = []
    for it in (1, iters):
        n0 = mesh.world.all_reduces
        st, cost = make_sharded_ba(mesh, iters=it)(*args)
        counts.append(mesh.world.all_reduces - n0)
    solve = make_sharded_ba(mesh, iters=iters)
    rep = torch.cat([st.p.reshape(-1), st.q.reshape(-1), cost.reshape(1)])
    equal = all(torch.equal(rep, c) for c in mesh.world.all_gather(rep))
    barrier(dev)
    ms = timed(lambda: solve(*args), dev)
    rec = dict(frames=frames, landmarks=L, iters=iters, ms_per_iteration_sharded=ms / iters,
               all_reduces_per_lm_iteration=(counts[1] - counts[0]) / (iters - 1),
               replicas_bitwise_equal=equal, cost=float(cost))
    if mesh.world.index == 0:
        ref_st, ref_cost = ba_solve(*args, iters=iters)
        rec.update(cost_rel=rel(cost, ref_cost), max_dp=float((st.p - ref_st.p).abs().max()),
                   max_dpts=float((st.pts - ref_st.pts).abs().max()))
        rec["ms_per_iteration_single"] = timed(lambda: ba_solve(*args, iters=iters), dev) / iters
        rec["within_bounds"] = bool(rec["cost_rel"] <= F64["ba_cost_rel"]
                                    and rec["max_dp"] <= F64["ba_p"]
                                    and rec["max_dpts"] <= F64["ba_pts"])
    barrier(dev)
    return rec


def run_inputs(mesh, dev, path: str, out_dir: str) -> None:
    """`--inputs`: the stored problems through the sharded functions; this
    rank's results to out_dir/rank{r}.npz."""
    d = np.load(path)
    inp = load_inputs(d, dev)
    res = {}
    if "step" in inp:
        layout = Layout(inp["step"][0].p.shape[1])
        step = make_sharded_vio_step(layout, ImuNoise(), SolverOptions(iters=inp["step_iters"]),
                                     mesh)
        out = step(*inp["step"])
        flatten("step", out, res)
        for i, r in enumerate(step.local):
            flatten(f"local{i}", r, res)
        nb = len(step.local)
        res["local_seqs"] = np.arange(mesh.seq_index * nb, (mesh.seq_index + 1) * nb)
    if "ba" in inp:
        st, cost = make_sharded_ba(mesh, iters=inp["ba_iters"])(*inp["ba"])
        flatten("ba/state", st, res)
        res["ba/cost"] = cost.cpu().numpy()
    if "jtj/J" in d:
        # the landmark-sharded JᵀJ reduction of tests/test_distributed.py
        J, r = (torch.from_numpy(d[k]).to(dev) for k in ("jtj/J", "jtj/r"))
        n = J.shape[0] // mesh.lm
        ls = slice(mesh.lm_index * n, (mesh.lm_index + 1) * n)
        Jl, rl = J[ls], r[ls]
        H, b = mesh.lm_axis.psum(Jl.T @ Jl, Jl.T @ rl)
        res["jtj/H"], res["jtj/b"] = H.cpu().numpy(), b.cpu().numpy()
    res["seq_index"], res["lm_index"] = np.asarray(mesh.seq_index), np.asarray(mesh.lm_index)
    np.savez(os.path.join(out_dir, f"rank{dist.get_rank()}.npz"), **res)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="nccl on cuda, gloo on cpu by default")
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--lm", type=int, default=None)
    ap.add_argument("--dtype", default="float64",
                    help="of the VIO step: float64, float32 or both, comma-separated; the BA "
                         "is float64")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--frames", type=int, default=11)
    ap.add_argument("--landmarks", default="1024", help="comma-separated, each divisible by lm")
    ap.add_argument("--ba-landmarks", type=int, default=4096)
    ap.add_argument("--inputs", default=None, help="an .npz of `save_inputs`")
    ap.add_argument("--out", default=None, help="with --inputs: where rank{r}.npz go")
    a = ap.parse_args(argv)
    t0 = time.perf_counter()
    dtypes = a.dtype.split(",")
    if not set(dtypes) <= {"float64", "float32"}:
        ap.error(f"--dtype {a.dtype}: float64 and float32 only")
    backend = a.backend or ("nccl" if a.device == "cuda" else "gloo")
    dev = init(backend, a.device)
    try:
        mesh = make_mesh(a.seq, a.lm)
        if a.inputs:
            run_inputs(mesh, dev, a.inputs, a.out)
            return 0
        rec = dict(backend=backend, world=mesh.world.size, seq=mesh.seq, lm=mesh.lm,
                   device=str(dev),
                   device_name=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   seconds_to_mesh=time.perf_counter() - t0, vio=[])
        for j, name in enumerate(dtypes):
            for i, L in enumerate(int(x) for x in a.landmarks.split(",")):
                args = step_inputs(mesh.seq, a.frames, L, getattr(torch, name), dev)
                for marg_old in (True, False):
                    rec["vio"].append(run_vio(mesh, dev, args, marg_old,
                                              profile=i == j == 0 and marg_old))
        rec["ba"] = run_ba(mesh, dev, a.frames, a.ba_landmarks)
        rec["seconds_in_main"] = time.perf_counter() - t0
        if mesh.world.index == 0:
            rec["ok"] = all(r["within_bounds"] and r["replicas_bitwise_equal"]
                            for r in rec["vio"] + [rec["ba"]])
            print(json.dumps(rec), flush=True)
            return 0 if rec["ok"] else 1
        return 0
    finally:
        dist.destroy_process_group()


# ---- the launcher -------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(nproc: int, args: list, timeout: float) -> list:
    """Run `python -m vins_tpu_torch.run_sharded *args` as `nproc` ranks on
    this host, each with the environment `torch.distributed.run` gives its
    workers and a time limit of `timeout` seconds.  When a rank fails or
    runs out of time, every rank still running is killed.  Returns each
    rank's (exit code, output); raises TimeoutError if the limit cut one."""
    port = free_port()
    base = dict(os.environ, MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(port), WORLD_SIZE=str(nproc), LOCAL_WORLD_SIZE=str(nproc))
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(nproc)]
        procs = [subprocess.Popen([sys.executable, "-m", "vins_tpu_torch.run_sharded", *args],
                                  env=dict(base, RANK=str(r), LOCAL_RANK=str(r)), cwd=ROOT,
                                  stdout=logs[r], stderr=subprocess.STDOUT)
                 for r in range(nproc)]
        deadline = time.monotonic() + timeout
        cut = False
        try:
            while any(p.poll() is None for p in procs):
                failed = any(p.returncode not in (None, 0) for p in procs)
                cut = time.monotonic() > deadline
                if failed or cut:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
    if cut:
        raise TimeoutError(f"run_sharded ranks cut at {timeout} s:\n" + "\n".join(outs))
    return [(p.returncode, o) for p, o in zip(procs, outs)]


if __name__ == "__main__":
    sys.exit(main())
