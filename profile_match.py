#!/usr/bin/env python
"""Stage timings of the batched correlative match program on this device.

    python profile_match.py [--batch 16] [--sizes 1536,2048,3072] [--out F]

Jobs come from the generated building log (io.benchmark, 180 beams): a
window of 10 scans at their true poses and the next scan as the query, at
the reference ROS node's settings (apps.online.DEFAULT_SEQ_CONFIG and
DEFAULT_LOOP_CONFIG).  Every time is the median of --repeats runs that end
in block_until_ready, after a warm-up run that compiles.

- grid build at each subgrid side S of --sizes: scatter, smear and
  quantize + bounds mask as separate programs and as one, with the fused
  program's kernel count and temporary bytes from XLA;
- lattice scoring of each search pass with element gathers and with window
  gathers (the two scorers matcher._pick_scorer chooses between);
- the whole match program (match_many of --batch jobs) with each pair of
  (coarse, fine) scorers.

Prints the card's name and power limit first; --out writes the numbers as
JSON.
"""
import argparse
import json
import os
import re
import tempfile
import time

import numpy as np
import jax
import jax.numpy as jnp

from yag_slam_tpu.apps.online import DEFAULT_LOOP_CONFIG, DEFAULT_SEQ_CONFIG
from yag_slam_tpu.core.scan import LocalizedRangeScan
from yag_slam_tpu.io.benchmark import generate_benchmark_log
from yag_slam_tpu.io.carmen import load_carmen_log
from yag_slam_tpu.matching import correlation as C
from yag_slam_tpu.matching import matcher as M
from yag_slam_tpu.utils.card import card_name_and_power_limit
from yag_slam_tpu.utils.compile_cache import enable_compile_cache

WINDOW = 10


def timed_ms(fn, *args, repeats=10):
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts))


def make_jobs(cfg, n_jobs, workdir):
    log, gtp, _ = generate_benchmark_log(os.path.join(workdir, "b.clf"),
                                         step=0.4, laps=2, n_beams=180)
    raw = load_carmen_log(log)
    gt = np.loadtxt(gtp)

    def scan(i, pose):
        c = raw[i]
        return LocalizedRangeScan(c.ranges, c.min_angle, c.max_angle,
                                  c.angle_increment, 0.0, c.max_range,
                                  cfg["range_threshold"], *pose)

    jobs = []
    for j in range(n_jobs):
        q = WINDOW + 7 * j
        base = [scan(i, gt[i]) for i in range(q - WINDOW, q)]
        jobs.append((scan(q, gt[q] + [0.03, -0.02, 0.01]), base))
    return jobs


def job_inputs(m, jobs):
    """Device inputs of the build and scoring stages for `jobs`."""
    P = m._ensure_point_cap([q for q, _ in jobs]
                           + [s for _, bs in jobs for s in bs])
    B = m._base_bucket(WINDOW)
    idx, mask, pose, q_idx, center, sub, S = m._assemble_jobs(jobs, P, B)
    G, res = m.grid_size, m.config.resolution
    lib = m.library.fields

    @jax.jit
    def prep(lib, idx, mask, pose, q_idx, center, sub):
        lx, ly = lib["lx"][idx], lib["ly"][idx]
        pc, ps = jnp.cos(pose[..., 2:3]), jnp.sin(pose[..., 2:3])
        wx = pose[..., 0:1] + pc * lx - ps * ly
        wy = pose[..., 1:2] + ps * lx + pc * ly
        keep = C.keep_mask_for_viewpoint(
            wx, wy, lib["anchor"][idx], lib["term"][idx],
            lib["has_run"][idx], mask[..., None],
            center[:, 0][:, None, None], center[:, 1][:, None, None])
        n_q = lib["n"][q_idx]
        lane = jnp.arange(P)
        qx = jnp.where(lane[None] < n_q[:, None], lib["lx"][q_idx], 1e9)
        qy = jnp.where(lane[None] < n_q[:, None], lib["ly"][q_idx], 1e9)
        ox = center[:, 0] - 0.5 * (G - 1) * res
        oy = center[:, 1] - 0.5 * (G - 1) * res
        return dict(wx=wx, wy=wy, keep=keep, ox=ox, oy=oy,
                    sox=sub[:, 0], soy=sub[:, 1], qx=qx, qy=qy,
                    n=n_q.astype(m.dtype), cx=center[:, 0],
                    cy=center[:, 1], ct=center[:, 2])

    return prep(lib, idx, mask, pose, q_idx, center, sub), S, P


def entry_kernels(compiled):
    """Kernels in the entry computation of a compiled program (fusions,
    custom calls and library calls)."""
    text = compiled.as_text()
    entry = text[text.index("ENTRY"):]
    entry = entry[:entry.index("\n}")]
    return len(re.findall(r"= \S+ (fusion|custom-call|scatter|gather)\(",
                          entry))


def profile_build(m, d, S, repeats):
    h, G, res = m._half, m.grid_size, m.config.resolution
    taps = tuple(float(v) for v in m._k1)
    N = d["wx"].shape[0]
    W = S + 2 * h
    # place every job's subgrid inside the grid (the real jobs' offsets
    # are for their own bucket)
    sox = jnp.clip(d["sox"], 0, max(G - S, 0))
    soy = jnp.clip(d["soy"], 0, max(G - S, 0))
    pts = (d["wx"], d["wy"], d["keep"], d["ox"], d["oy"], sox, soy)
    kw = dict(G=G, S=S, h=h, res=res)
    scatter = jax.jit(lambda *a: C.build_occupancy_padded(
        *a, dtype=jnp.float32, **kw))
    smear = jax.jit(lambda o: C.smear_grid(o, h=h, S=S, taps=taps))
    quant = jax.jit(lambda g, sx, sy: C.mask_past_grid(C.quantize_grid(g),
                                                        sx, sy, G))
    build = jax.jit(lambda *a: C.build_quantized_subgrids(
        *a, taps=taps, dtype=jnp.float32, **kw)[0])
    occ = jax.block_until_ready(scatter(*pts))
    cg = jax.block_until_ready(smear(occ))
    out = {
        "S": S, "h": h, "N": N,
        "scatter_ms": timed_ms(scatter, *pts, repeats=repeats),
        "smear_ms": timed_ms(smear, occ, repeats=repeats),
        "quantize_mask_ms": timed_ms(quant, cg, sox, soy, repeats=repeats),
        "build_ms": timed_ms(build, *pts, repeats=repeats),
    }
    compiled = build.lower(*pts).compile()
    out["build_kernels"] = entry_kernels(compiled)
    out["build_temp_bytes"] = compiled.memory_analysis().temp_size_in_bytes
    # bytes: one f32 pass-1 intermediate (N, W, S) written and read back,
    # besides the occupancy plane and the quantized output
    inter = 4 * N * W * S
    out["pass1_intermediate_bytes"] = inter
    out["min_bytes_no_intermediate"] = 4 * N * (2 * W * W + S * S)
    out["bytes_one_round_trip"] = out["min_bytes_no_intermediate"] + 2 * inter
    out["build_gbps_one_round_trip"] = (
        out["bytes_one_round_trip"] / out["build_ms"] / 1e6)
    return out


def profile_scorers(m, d, S, spec, stride, xy_size, ang_size, ang_res,
                    repeats):
    G, res = m.grid_size, m.config.resolution
    taps = tuple(float(v) for v in m._k1)
    q2d, _ = jax.jit(lambda *a: C.build_quantized_subgrids(
        *a, G=G, S=S, h=m._half, res=res, taps=taps, dtype=m.dtype))(
        d["wx"], d["wy"], d["keep"], d["ox"], d["oy"], d["sox"], d["soy"])
    N = q2d.shape[0]
    args = (d["qx"], d["qy"], d["n"], d["cx"], d["cy"], d["ct"], d["ox"],
            d["oy"], d["sox"], d["soy"])
    kw = dict(spec=spec, xy_size=xy_size, xy_res=stride * res,
              ang_size=ang_size, ang_res=ang_res, grid_size=G, grid_res=res,
              sub_size=S, penalize=True, dtype=m.dtype)

    def element(q, *a):
        return C.score_lattice_batched(q, *a, **kw)[0]

    def patch(q, *a):
        return C.score_lattice_patch_batched(q, *a, **kw)[0]

    e, p = jax.jit(element), jax.jit(patch)
    diff = float(jnp.max(jnp.abs(e(q2d, *args) - p(q2d, *args))))
    return {"lattice": list(spec), "stride": stride,
            "element_ms": timed_ms(e, q2d, *args, repeats=repeats),
            "patch_ms": timed_ms(p, q2d, *args, repeats=repeats),
            "max_abs_diff": diff}


def profile_program(cfg, loop, jobs, repeats):
    """match_many over `jobs` with each (coarse, fine) scorer pair forced."""
    out = {}
    pairs = [(c, f) for c in ("element", "patch")
             for f in (("element",) if loop else ("element", "patch"))]
    for coarse, fine in pairs:
        M._pick_scorer = (lambda spec, stride, c=coarse, f=fine:
                          c if stride == 2 else f)
        m = M.CorrelativeScanMatcher(cfg, loop=loop)
        m.match_many(jobs, True, not loop)
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            m.match_many(jobs, True, not loop)
            ts.append(time.perf_counter() - t0)
        out[f"{coarse}+{fine}_ms"] = 1e3 * float(np.median(ts))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--sizes", default="1536,2048,3072")
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    enable_compile_cache()
    dev = jax.devices()[0]
    print(f"card: {card_name_and_power_limit()}; {dev.platform} {dev.device_kind}; "
          f"jax {jax.__version__}", flush=True)
    pick = M._pick_scorer
    results = {"card": card_name_and_power_limit(), "device_kind": dev.device_kind,
               "batch": args.batch}
    with tempfile.TemporaryDirectory() as wd:
        for name, cfg, loop in (
            ("seq", DEFAULT_SEQ_CONFIG, False),
            ("seq_search0.5", dict(DEFAULT_SEQ_CONFIG, search_size=0.5),
             False),
            ("loop", DEFAULT_LOOP_CONFIG, True),
        ):
            m = M.CorrelativeScanMatcher(cfg, loop=loop)
            c = m.config
            jobs = make_jobs(cfg, args.batch, wd)
            d, S, P = job_inputs(m, jobs)
            r = {"S": S, "P": P, "G": m.grid_size, "h": m._half}
            if name == "seq":
                r["build"] = [profile_build(m, d, int(s), args.repeats)
                              for s in args.sizes.split(",")]
                for b in r["build"]:
                    print(f"[build S={b['S']} h={b['h']} N={b['N']}] "
                          f"scatter {b['scatter_ms']:.3f} ms, smear "
                          f"{b['smear_ms']:.3f} ms, quantize+mask "
                          f"{b['quantize_mask_ms']:.3f} ms; one program "
                          f"{b['build_ms']:.3f} ms in {b['build_kernels']} "
                          f"kernels, temp {b['build_temp_bytes'] / 2**20:.1f}"
                          f" MiB (pass-1 intermediate "
                          f"{b['pass1_intermediate_bytes'] / 2**20:.1f} MiB),"
                          f" {b['build_gbps_one_round_trip']:.0f} GB/s if "
                          f"it makes one round trip", flush=True)
            passes = [("coarse", C.LatticeSpec.from_search(
                0, 0, 0, c.search_size * 0.5, c.resolution * 2,
                c.coarse_search_angle_offset * 0.5,
                c.coarse_angle_resolution), 2, c.search_size * 0.5,
                c.coarse_search_angle_offset * 0.5,
                c.coarse_angle_resolution)]
            if not loop:
                passes.append(("fine", C.LatticeSpec.from_search(
                    0, 0, 0, c.resolution * 2, c.resolution,
                    M._FINE_ANGLE_SIZE, c.fine_search_angle_resolution), 1,
                    c.resolution * 2, M._FINE_ANGLE_SIZE,
                    c.fine_search_angle_resolution))
            for pname, spec, stride, xy_size, ang_size, ang_res in passes:
                s = profile_scorers(m, d, S, spec, stride, xy_size,
                                    ang_size, ang_res, args.repeats)
                r[f"score_{pname}"] = s
                print(f"[{name} {pname} {spec.nx}x{spec.ny}x{spec.nt} "
                      f"stride {stride} S={S} P={P}] element "
                      f"{s['element_ms']:.3f} ms, patch {s['patch_ms']:.3f} "
                      f"ms (max |diff| {s['max_abs_diff']:.2e})",
                      flush=True)
            r["program"] = profile_program(cfg, loop, jobs, args.repeats)
            M._pick_scorer = pick
            print(f"[{name} program, {args.batch} jobs] "
                  + ", ".join(f"{k} {v:.3f}" for k, v in r["program"].items()),
                  flush=True)
            results[name] = r
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print("wrote", args.out)


if __name__ == "__main__":
    main()
