"""Experiments on the lk_pyramid kernel on one CUDA card: where a step's
cycles go, and how variants of the kernel compare with it.

Each variant is the source `csrc/lk_pyramid.cu` with a few lines replaced
(`VARIANTS`); it is built with nvcc into `build/kernels/variants/` and timed
in turns with the kernel itself, one launch per tracked frame at the main
path's inputs (`chip_smoke.frame_inputs`, frame 21), with CUDA events.
Variants whose name starts with `clock` also log clock64 counts per feature
and level: the template's work, and each step's parts (waiting for its
patch loads, the samples and products, the two shuffle sums, the step
itself).  `clock_reload` loads each step's patch a second time, which then
hits L1.  Prints one JSON object.

    python3 -m vins_tpu_torch.bench_lk      (from the repo root; needs a CUDA device)
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_STEP_ORIGIN = '''          const int x = clampi(tx - kPad + clampi(lane - 1, 0, kP1 - 1), 0, L.W - 1);
          const int y0 = ty - kPad;
'''
_STEP_LOADS = '''          float col[kP1];
#pragma unroll
          for (int r = 0; r < kP1; ++r)
            col[r] = __ldg(L.img1 + (clampi(y0 + r, 0, L.H - 1) * L.W + x));
'''
_LEVEL_START = '''      cp_async_wait(l);  // this level's group has landed; lower levels' may not have
'''
_GATE = '''      level_ok = min_eig > p.min_eig_thresh;
'''
_WINDOW = '''        const int WS = kP1 + 2 * L.search;
        const int wx0 = clampi(floor_idx(gcx) - kHalf - L.search + kPad, 0, L.W + 2 * kPad - WS);
        const int wy0 = clampi(floor_idx(gcy) - kHalf - L.search + kPad, 0, L.H + 2 * kPad - WS);
'''


def _warm(op: str) -> list:
    """Touch every 32-byte sector of the level's search window at the start
    of the level, by `op` on the address `src`."""
    return [(_LEVEL_START, '''      float warm = 0.f;
      {
''' + _WINDOW + '''        const int nsec = (WS + 7) / 8 + 1;
        for (int i = lane; i < WS * nsec; i += 32) {
          const int r = i / nsec, k = i - r * nsec;
          const float* src = L.img1 + clampi(wy0 - kPad + r, 0, L.H - 1) * L.W
                           + clampi(wx0 - kPad + min(8 * k, WS - 1), 0, L.W - 1);
          ''' + op + '''
        }
      }
''' + _LEVEL_START)]


# clock64 logging: [template, steps, loads, samples, sums, step, steps run, entry -> level end]
_CLOCK = [
    ('namespace {\n', 'namespace {\n__device__ float g_clk[512][4][8];\n'),
    ('  const float ptx = p.pts[2 * n], pty = p.pts[2 * n + 1];\n',
     '  const long long t_entry = clock64();\n'
     '  const float ptx = p.pts[2 * n], pty = p.pts[2 * n + 1];\n'),
    ('    int steps = 0;\n    bool level_ok = false;\n',
     '    int steps = 0;\n    bool level_ok = false;\n'
     '    long long c_tpl = 0, c_loop = 0, c_load = 0, c_acc = 0, c_red = 0, c_tail = 0;\n'
     '    const long long t_l0 = clock64();\n'),
    (_GATE, _GATE + '      c_tpl = clock64() - t_l0;\n      const long long t_loop0 = clock64();\n'),
    ('          const float gfx = ux - floorf(ux), gfy = uy - floorf(uy);\n',
     '          const long long s0 = clock64();\n'
     '          const float gfx = ux - floorf(ux), gfy = uy - floorf(uy);\n'),
    # wait for every lane's loads (a sum that depends on all of them) before s1
    ('          float top = col[0], top_r = __shfl_down_sync(0xffffffffu, col[0], 1);\n',
     '          float top = col[0], top_r = __shfl_down_sync(0xffffffffu, col[0], 1);\n'
     '          float sink = top_r;\n'
     '          for (int r = 1; r < kP1; ++r) sink += col[r];\n'
     '          if (sink == 12345.678f) top += 1e-30f;\n'
     '          const long long s1 = clock64();\n'),
    ('          b0 = warp_sum(b0);\n          b1 = warp_sum(b1);\n',
     '          const long long s2 = clock64();\n'
     '          b0 = warp_sum(b0);\n          b1 = warp_sum(b1);\n'
     '          const long long s3 = clock64();\n'
     '          c_load += s1 - s0; c_acc += s2 - s1; c_red += s3 - s2;\n'),
    ('          if (!(sqrtf(sx * sx + sy * sy) > p.eps)) break;\n          gcx += sx;\n'
     '          gcy += sy;\n        }\n',
     '          if (!(sqrtf(sx * sx + sy * sy) > p.eps)) { c_tail += clock64() - s3; break; }\n'
     '          gcx += sx;\n          gcy += sy;\n          c_tail += clock64() - s3;\n'
     '        }\n        c_loop = clock64() - t_loop0;\n'),
    ('    if (p.trace != nullptr && lane == 0) {\n',
     '    if (lane == 0 && n < 512) {\n'
     '      float* d = g_clk[n][l];\n'
     '      d[0] = c_tpl; d[1] = c_loop; d[2] = c_load; d[3] = c_acc; d[4] = c_red;\n'
     '      d[5] = c_tail; d[6] = steps; d[7] = clock64() - t_entry;\n'
     '    }\n'
     '    if (p.trace != nullptr && lane == 0) {\n'),
    (None, '\nextern "C" int lk_clk_copy(float* host) {\n'
           '  return (int)cudaMemcpyFromSymbol(host, g_clk, sizeof(g_clk));\n}\n'),
]

VARIANTS = {
    "clock": _CLOCK,
    # two paths: rows formed by a running pointer when the patch lies inside
    # the image, clamped one by one otherwise
    "rows_two_paths": [(_STEP_LOADS, '''          const float* q = L.img1 + x;
          float col[kP1];
          if (y0 >= 0 && y0 + kP1 <= L.H) {
            q += y0 * L.W;
#pragma unroll
            for (int r = 0; r < kP1; ++r) col[r] = __ldg(q + r * L.W);
          } else {
#pragma unroll
            for (int r = 0; r < kP1; ++r) col[r] = __ldg(q + clampi(y0 + r, 0, L.H - 1) * L.W);
          }
''')],
    # a second, volatile load of the same patch inside the step, timed in the
    # `sums` slot's place: what the patch costs when it hits L1
    "clock_reload": _CLOCK + [
        ('          const long long s1 = clock64();\n',
         '          const long long s1 = clock64();\n'
         '          float c2[kP1], again = 0.f;\n'
         '#pragma unroll\n'
         '          for (int r = 0; r < kP1; ++r)\n'
         '            asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(c2[r])\n'
         '                         : "l"(L.img1 + (clampi(y0 + r, 0, L.H - 1) * L.W + x)));\n'
         '          for (int r = 0; r < kP1; ++r) again += c2[r];\n'
         '          if (again == 12345.678f) top += 1e-30f;\n'
         '          const long long s1b = clock64();\n'),
        ('          const long long s2 = clock64();\n',
         '          const long long s2 = clock64() - (s1b - s1);\n'),
        ('          c_load += s1 - s0; c_acc += s2 - s1; c_red += s3 - s2;\n',
         '          c_load += s1 - s0; c_acc += s2 - s1; c_red += s1b - s1;\n'),
    ],
    "warm_prefetch": _warm('asm volatile("prefetch.global.L1 [%0];" ::"l"(src));'),
    "warm_load": _warm('float v;\n          asm volatile("ld.global.nc.f32 %0, [%1];" '
                       ': "=f"(v) : "l"(src));\n          warm += v;') + [
        (_GATE, _GATE + '      if (warm == 1.2345e30f) level_ok = !level_ok;  // waits here\n')],
    "carveout_l1": [
        ('  const size_t smem = smem_bytes(p.levels, warps_per_block);\n',
         '  const size_t smem = smem_bytes(p.levels, warps_per_block);\n'
         '  {\n'
         '    const cudaError_t e = cudaFuncSetAttribute(\n'
         '        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 10);\n'
         '    if (e != cudaSuccess) return static_cast<int>(e);\n'
         '  }\n')],
    # keep the patch in registers while the integer corner stays, and load the
    # patch at the corner the last move extrapolates to while the step computes
    "speculate": [
        (_STEP_LOADS, '''          if (tx != cx || ty != cy) {
            if (tx == nx && ty == ny) {
#pragma unroll
              for (int r = 0; r < kP1; ++r) col[r] = nxt[r];
            } else {
              load(col, tx, ty);
            }
            if (cx != -1 << 30) { dx = tx - cx; dy = ty - cy; }
            cx = tx;
            cy = ty;
            const int ex = wx0 + clampi(tx + dx - wx0, 0, WS - kP1);
            const int ey = wy0 + clampi(ty + dy - wy0, 0, WS - kP1);
            if (ex != tx || ey != ty) {
              load(nxt, ex, ey);
              nx = ex;
              ny = ey;
            }
          }
'''),
        ('        for (int it = 0; it < p.iters; ++it) {\n', '''        float col[kP1], nxt[kP1];
        int cx = -1 << 30, cy = 0, nx = -1 << 30, ny = 0, dx = 0, dy = 0;
        auto load = [&](float (&dst)[kP1], int x, int y) {
          const float* q = L.img1 + clampi(x - kPad + clampi(lane - 1, 0, kP1 - 1), 0, L.W - 1);
          const int y0 = y - kPad;
#pragma unroll
          for (int r = 0; r < kP1; ++r) dst[r] = __ldg(q + clampi(y0 + r, 0, L.H - 1) * L.W);
        };
        for (int it = 0; it < p.iters; ++it) {
'''),
        (_STEP_ORIGIN, ''),
    ],
    # the search window of each level staged in the warp's shared memory by
    # 4-byte cp.async, issued before the template's work; the steps read it
    "stage_window": [
        ('  float* tpl_patch = smem + warp * (p.levels * kP0 * kP0);  // levels x P0 x P0\n',
         '  float* tpl_patch = smem + warp * (p.levels * kP0 * kP0 + kStageWS * kStageWS);\n'
         '  float* window = tpl_patch + p.levels * kP0 * kP0;\n'),
        ('constexpr int kMaxLevels = 4;\n',
         'constexpr int kMaxLevels = 4;\nconstexpr int kStageWS = kP1 + 2 * 32;\n'),
        ('    default: asm volatile("cp.async.wait_group 3;\\n" ::: "memory"); break;',
         '    case 3: asm volatile("cp.async.wait_group 3;\\n" ::: "memory"); break;\n'
         '    default: asm volatile("cp.async.wait_group 4;\\n" ::: "memory"); break;'),
        (_LEVEL_START, _WINDOW.replace('        ', '      ') + '''      for (int r = 0; r < WS; ++r) {
        const float* row = L.img1 + clampi(wy0 - kPad + r, 0, L.H - 1) * L.W;
        for (int c = lane; c < WS; c += 32)
          cp_async4(window + r * WS + c, row + clampi(wx0 - kPad + c, 0, L.W - 1));
      }
      cp_async_commit();
      cp_async_wait(l + 1);  // the template has landed; the window may not have
'''),
        ('      if (level_ok) {\n', '      cp_async_wait(0);\n      __syncwarp();\n'
                                   '      if (level_ok) {\n'),
        ('''        // the search window, in padded coordinates, fixed around the guess
        const int WS = kP1 + 2 * L.search;
        const int wx0 = clampi(floor_idx(gcx) - kHalf - L.search + kPad, 0,
                               L.W + 2 * kPad - WS);
        const int wy0 = clampi(floor_idx(gcy) - kHalf - L.search + kPad, 0,
                               L.H + 2 * kPad - WS);
''', ''),
        (_STEP_ORIGIN, ''),
        (_STEP_LOADS, '''          const float* q = window + (ty - wy0) * WS + (tx - wx0) + clampi(lane - 1, 0, kP1 - 1);
          float col[kP1];
#pragma unroll
          for (int r = 0; r < kP1; ++r) col[r] = q[r * WS];
'''),
        ('    if (p.trace != nullptr && lane == 0) {\n',
         '    __syncwarp();\n    if (p.trace != nullptr && lane == 0) {\n'),
        ('       * static_cast<size_t>(levels * kP0 * kP0);',
         '       * static_cast<size_t>(levels * kP0 * kP0 + kStageWS * kStageWS);'),
    ],
}
CLOCK_FIELDS = ("template", "steps", "loads", "samples", "sums", "step", "steps_run",
                "entry_to_level_end")


def variant_source(name: str) -> str:
    from vins_tpu_torch.build import CSRC

    src = (CSRC / "lk_pyramid.cu").read_text()
    for old, new in VARIANTS[name]:
        if old is None:
            src += new
            continue
        if old not in src:
            raise RuntimeError(f"variant {name}: the source has changed; missing:\n{old}")
        src = src.replace(old, new, 1)
    return src


def build_variants(names) -> dict:
    """One nvcc per variant, all started together; {name: (library, ptxas lines)}."""
    from vins_tpu_torch import build

    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = out_dir / f"lk_pyramid_{name}.cu"
        cu.write_text(variant_source(name))
        so = out_dir / f"liblk_pyramid_{name}.so"
        procs[name] = (so, subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                                             str(cu)], stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        built[name] = (so, [ln.split(":", 1)[1].strip() for ln in log.splitlines() if "Used" in ln])
    return built


def wrapper(so):
    """An LKPyramid whose launches go to the library `so`."""
    from vins_tpu_torch import build
    from vins_tpu_torch.frontend.klt_cuda import LKPyramid

    inst, load = LKPyramid(), build.load
    build.load = lambda name: ctypes.CDLL(str(so))
    try:
        inst._library()
    finally:
        build.load = load
    return inst


def clock_summary(inst, args, valid, n: int) -> dict:
    """Median and largest clock64 counts per level over the valid features
    of one launch, the per-step medians, and the slowest feature's total."""
    import numpy as np
    import torch

    inst.launch(*args)
    torch.cuda.synchronize()
    buf = np.zeros((512, 4, 8), np.float32)
    inst._lib.lk_clk_copy.argtypes = [ctypes.c_void_p]
    if inst._lib.lk_clk_copy(buf.ctypes.data) != 0:
        raise RuntimeError("lk_clk_copy failed")
    d = buf[:n][valid.cpu().numpy()]
    out = {}
    for lvl in (2, 1, 0):
        x = d[:, lvl]
        steps = np.maximum(x[:, 6], 1)
        out[f"level_{lvl}"] = {
            "median": dict(zip(CLOCK_FIELDS, np.median(x, 0).tolist())),
            "max": dict(zip(CLOCK_FIELDS, x.max(0).tolist())),
            "per_step_median": {f: float(np.median(x[:, i] / steps))
                                for i, f in ((2, "loads"), (3, "samples"), (4, "sums"),
                                             (5, "step"))}}
    out["slowest_feature_cycles"] = float(d[:, 0, 7].max())
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_lk: no CUDA device is visible")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from vins_tpu_torch import build
    from vins_tpu_torch.frontend.klt_cuda import lk_pyramid
    from vins_tpu_torch.sim import proxy

    names = sys.argv[1:] or list(VARIANTS)
    build.build_all(("lk_pyramid",))
    built = build_variants(names)
    dev = torch.device("cuda")
    seq = proxy.render_sequence(30, device=dev)
    pyr0, pyr1, pts, valid = cs.frame_inputs(seq, dev)
    args = (pyr0, pyr1, pts, valid)
    g_ref, ok_ref = lk_pyramid(*args)
    insts = {name: wrapper(so) for name, (so, _) in built.items()}
    result = {"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                      "--format=csv,noheader"], capture_output=True,
                                     text=True, timeout=60).stdout.strip(),
              "ptxas": {name: lines for name, (_, lines) in built.items()},
              "steps_run": {}}
    for name, inst in insts.items():
        g, ok = inst.launch(*args)
        torch.cuda.synchronize()
        same = torch.equal(ok, ok_ref) and float((g - g_ref)[ok].abs().max()) <= 1e-3
        if not same:
            raise SystemExit(f"bench_lk: variant {name} disagrees with the kernel")
    trace = torch.zeros((pts.shape[0], 3, 4), device=dev)
    lk_pyramid.launch(*args, trace=trace)
    steps = trace[:, :, 3].sum(1)[valid]
    result["steps_run"] = {"max": float(steps.max()), "mean": float(steps.mean()),
                           "features_at_30": int((steps == 30).sum()), "valid": int(valid.sum())}
    fns = {"kernel": (lambda: lk_pyramid.launch(*args), 2_000_000)}
    fns.update({name: (lambda inst=inst: inst.launch(*args), 2_000_000)
                for name, inst in insts.items()})
    result["us_per_frame"] = {k: v * 1e3 for k, v in cs.device_ms(fns, runs=41).items()}
    result["clock"] = {name: clock_summary(insts[name], args, valid, pts.shape[0])
                       for name in insts if name.startswith("clock")}
    result["sm_clock"] = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                                         "--format=csv,noheader"], capture_output=True,
                                        text=True, timeout=60).stdout.strip()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
