#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's ALS training goes, on one
NVIDIA GPU.

    python3 -m incubator_predictionio_tpu_torch.profile_training

At ML-20M width (138,493 users x 26,744 items x rank 128, 20,000,000
distinct planted ratings from ``utils/planted.py``), the buckets are built
once and three single sweeps are profiled with ``torch.profiler``: a bf16
sweep and an f32 sweep through the kernels (each bucket on the entry
``ops/als._route`` gives it), and an f32 sweep of the plain route
(``use_kernel=False``). For each it prints one JSON line with the host
wall, the device time by kernel name, the device's idle share, and the
kernel route's bound per half-sweep: the sum of
``ops/als_kernels.bucket_bound`` over its buckets (f32 products at the
3xTF32 rate; in f32 also on the FMA units, ``bound_fma_ms``). Then one
``{"bucket": ...}`` line for each bucket of an f32 sweep: its device ms
against its bound. The first line is the card's name and power
limit from nvidia-smi. Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from incubator_predictionio_tpu_torch import runtime
from incubator_predictionio_tpu_torch.ops import als
from incubator_predictionio_tpu_torch.ops import als_kernels as ak
from incubator_predictionio_tpu_torch.utils import planted

RANK, L2 = 128, 0.03


#: stage 1's template flag GATHER (the fused entry), demangled or mangled
_GATHER = re.compile(
    r"gram_slice_kernel<\d+, [^,]+, (true|false)"
    r"|gram_tile_kernel<[^,]+, (true|false)"
    r"|gram_slice_kernelILi\d+E(?:f|13__nv_bfloat16)Lb([01])"
    r"|gram_tile_kernelI(?:f|13__nv_bfloat16)Lb([01])")


def _short(name: str) -> str:
    """A kernel's name for the report; the ALS kernels by entry (the
    profiler gives them mangled or demangled): stage 1 by its GATHER flag,
    the sliced rows' reduce and solve, shared by both entries, apart."""
    if "rows_solve_kernel" in name:
        return "als_solve_cg_rows8"
    if "gather_rows" in name:  # the two-stage entries' gathered block
        return "als_solve_cg gather"
    m = _GATHER.search(name)
    if m:
        flag = next(g for g in m.groups() if g is not None)
        return ("als_fused_solve_cg" if flag in ("true", "1")
                else "als_solve_cg")
    if "gram_" in name or "wide_solve" in name:
        return "als stage 2"
    return name[:70]


def device_ms(prof) -> dict:
    out: dict = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA \
                and ev.self_device_time_total > 0:
            key = _short(ev.key)
            out[key] = out.get(key, 0.0) + ev.self_device_time_total / 1e3
    return out


def side_work(tree) -> dict:
    """Observations and rows of one side's buckets, all kernel-routed."""
    return {"nnz": sum(float(mask.sum()) for _r, _c, _v, mask in tree),
            "rows": sum(int((row_ids >= 0).sum())
                        for row_ids, _c, _v, _m in tree)}


def side_bound(tree, bf16: bool, iters: int) -> dict:
    """The least time of one side's bucket solves in one sweep: the
    sum of each bucket's bound (f32 products at the 3xTF32 rate), and in
    f32 the same with them on the FMA units (``bound_fma_ms``)."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    by_ms = {"bytes": 0.0, "operations": 0.0}
    fma_ms = 0.0
    for _row_ids, cols, _vals, mask in tree:
        ms, by = ak.bucket_bound(cols, mask, RANK, iters, als.CG_WARMSTART,
                                 dtype)
        by_ms[by] += ms
        if not bf16:
            fma_ms += ak.bucket_bound(cols, mask, RANK, iters,
                                      als.CG_WARMSTART, dtype,
                                      f32_flops=runtime.F32_FLOPS)[0]
    out = {"bound_ms": sum(by_ms.values()),
           "bound_by": max(by_ms, key=by_ms.get)}
    if not bf16:
        out["bound_fma_ms"] = fma_ms
    return out


def bucket_times(state, trees) -> list:
    """Device ms (CUDA events, median of 3) of each bucket's solve in one
    f32 sweep, on the entry ``_mixed_run`` routes it to, beside its
    bound."""
    out = []
    for side, tree, other, prev in (
            ("user", trees[0], state.item_factors, state.user_factors),
            ("item", trees[1], state.user_factors, state.item_factors)):
        for row_ids, cols, vals, mask in tree:
            d = cols.shape[1]
            x0 = als._gather_x0(prev, row_ids)
            route = als._route(d, RANK, True, 0, True)
            solver, row_elems = als._bucket_solver(
                route, other, L2, True, torch.float32, als.CG_ITERS, d)

            times = []
            for _ in range(4):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                als._solve_bucket_chunked(
                    solver, cols, vals, mask, RANK, row_elems=row_elems,
                    x0=x0)
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
            rows, nnz = int((row_ids >= 0).sum()), float(mask.sum())
            bound_ms, bound_by = ak.bucket_bound(cols, mask, RANK,
                                                 als.CG_ITERS, True,
                                                 torch.float32)
            fma_ms = ak.bucket_bound(cols, mask, RANK, als.CG_ITERS, True,
                                     torch.float32,
                                     f32_flops=runtime.F32_FLOPS)[0]
            out.append({
                "side": side, "entry": {"fused": "als_fused_solve_cg",
                                        "rows8": "als_solve_cg_rows8",
                                        "rows1": "als_solve_cg"}[route],
                "D": d, "rows": rows, "nnz": nnz,
                "ms": sorted(times[1:])[1], "bound_ms": bound_ms,
                "bound_by": bound_by, "bound_fma_ms": fma_ms})
    return out


def profile_sweep(state, trees, bf16: bool, use_kernel: bool) -> dict:
    u_tree, i_tree, u_hv, i_hv = trees
    kw = dict(use_kernel=use_kernel)
    als._mixed_run(state, u_tree, i_tree, L2, 1, int(bf16), True,
                   torch.float32, u_hv, i_hv, **kw)  # warm-up
    torch.cuda.synchronize()
    runtime.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        als._mixed_run(state, u_tree, i_tree, L2, 1, int(bf16), True,
                       torch.float32, u_hv, i_hv, **kw)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    by_name = device_ms(prof)
    busy = sum(by_name.values())
    # the ten largest, and every ALS kernel of the port however small
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:10])
    top.update({k: v for k, v in by_name.items() if k.startswith("als_")})
    return {"sweep": "bf16" if bf16 else "f32",
            "route": "kernel" if use_kernel else "plain",
            "wall_ms": wall, "device_ms": busy,
            "device_idle_share": 1.0 - busy / wall,
            "device_ms_by_name": top,
            "launches": {k: v for k, v in runtime.launch_counts().items()
                         if v}}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    runtime.build_kernels()
    users, items, ratings, _ = planted.planted_ratings()
    n_u, n_i = planted.ML20M_USERS, planted.ML20M_ITEMS
    trees = als.prepare_trees(users, items, ratings, n_u, n_i, device=dev)
    state = als.als_init(torch.Generator().manual_seed(0), n_u, n_i, RANK,
                         device=dev)
    print(json.dumps({"user_side": side_work(trees[0]),
                      "item_side": side_work(trees[1])}), flush=True)
    for bf16, use_kernel in ((True, True), (False, True), (False, False)):
        row = profile_sweep(state, trees, bf16, use_kernel)
        if use_kernel:
            iters = als.CG_ITERS_BF16 if bf16 else als.CG_ITERS
            row["bound"] = {
                "user_half_sweep": side_bound(trees[0], bf16, iters),
                "item_half_sweep": side_bound(trees[1], bf16, iters)}
        print(json.dumps(row), flush=True)
    for row in bucket_times(state, trees):
        print(json.dumps({"bucket": row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
