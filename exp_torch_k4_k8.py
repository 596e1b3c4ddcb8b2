"""K4 (the int8-weight matmul) and K8's backward (LayerNorm) on one CUDA card:
their device time under other plans, and beside an older tree's kernels.

    python3 exp_torch_k4_k8.py
    python3 exp_torch_k4_k8.py --parent-ab DIR

The first form sweeps, on seeded inputs (chip_smoke's _k4_inputs; bf16 x,
fp32 bias):
  - K4's skinny schedule at GPT-2 small's two decode products ([8, 768] x
    [768, 3072] and [8, 3072] x [3072, 768]) under every n tile (32, 64,
    128 columns) and k split count (1 .. 16, the blocks of one cluster) it
    can hold, the plan's own marked;
  - the skinny/wide threshold: both schedules forced at m 8 .. 64 on both
    products, and wide (and the plan) at m 65 .. 256;
  - K8's backward at [16384, 1024] and [8192, 768] bf16 at 1 and 2 blocks
    an SM;
each beside its bound (chip_smoke's _bound: bytes over 3.35 TB/s or bf16
operations over 989 TFLOP/s, the larger).

The second form times K4 at chip_smoke's K4_SHAPES and K8's backward at
both shapes in four processes: the tree in DIR (an unpacked older checkout,
whose package has the same ``ops.int8_matmul`` and
``ops.fused.layer_norm_bwd_cuda``), this tree, this tree, DIR, each on the
same seeded inputs, and prints each side's device ms and their ratio.
``--times [--package DIR]`` is one such process.

    python3 exp_torch_k4_k8.py --phases

builds copies of csrc/int8_matmul.cu and csrc/fused.cu under
build/exp_k4_k8_phases/ with one phase left out at a time (one nvcc a
variant, all started together; a variant computes wrong outputs by design,
it only bounds what the phase costs) and times each beside the whole
kernel, at the plan's own schedule: skinny at both decode shapes without
its cluster exchange (no cluster barrier; each rank reads its own partial
only),
without its weight copy, without its products; wide at both prefill shapes
without the consumers' dequantizing conversion, without the int8 weight's
TMA loads, without both, without wgmma; K8's backward at both shapes
without its dx stores, without its final reduce kernel, without its
block's partial sums, and with one row in flight a warp (each row copied
only when it is reduced, not while the one before it is). It fails loudly where a source no longer holds a
phase it cuts.

A report, not a check; it imports nothing of JAX.
"""

from __future__ import annotations

import importlib
import json
import statistics
import subprocess
import sys

import numpy as np

import chip_smoke

DECODE = ((8, 768, 3072), (8, 3072, 768))      # (m, k, n)
LN_SHAPES = ((16384, 1024), (8192, 768))


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _ms(fn, reps=3):
    """Median of ``reps`` device-time readings (chip_smoke._device_ms)."""
    return statistics.median(chip_smoke._device_ms(fn) for _ in range(reps))


def _k4_case(m, k, n, seed):
    import torch
    x, wq, scale, bias = chip_smoke._k4_inputs(m, k, n,
                                               np.random.default_rng(seed))
    x = x.to(torch.bfloat16)
    bound = chip_smoke._bound(chip_smoke._nbytes(x, wq, scale, bias)
                              + m * n * 2, 2 * m * k * n)[0]
    return x, wq, scale, bias, bound


def _forced(quant, p, fn):
    """``fn``'s device ms with the wrapper's plan forced to ``p``."""
    cached = quant._cached_plan
    quant._cached_plan = lambda *a: p
    try:
        return _ms(fn)
    finally:
        quant._cached_plan = cached


def k4_sweeps(card):
    from np_modeling_tpu_torch import ops
    from np_modeling_tpu_torch.ops.fused import sm_count
    quant = importlib.import_module("np_modeling_tpu_torch.ops.quantization")
    sms = sm_count("cuda")
    for m, k, n in DECODE:
        x, wq, scale, bias, bound = _k4_case(m, k, n, chip_smoke.SEED + 11)
        own = quant.plan(m, n, k, sms)
        line = []
        for tile in quant.SKINNY_TILES:
            for asked in quant.SKINNY_SPLITS:
                rows, splits = quant.skinny_split(k, asked)
                if rows > quant.SKINNY_MAX_ROWS or any(
                        f"{tile} x {splits} " in s for s in line):
                    continue
                p = quant.Plan("skinny", tile, splits, splits)
                ms = _forced(quant, p,
                             lambda: ops.int8_matmul(x, wq, scale, bias))
                blocks = -(-n // tile) * splits
                line.append(f"{tile} x {splits} ({blocks} blocks"
                            f"{', the plan' if p == own else ''}) {ms:.5f}")
        print(f"K4 skinny [{m}, {k}] x [{k}, {n}]: bound {bound:.5f} ms; "
              f"device ms by n tile x k splits: " + "; ".join(line)
              + f" [{card}]")
    for k, n in ((768, 3072), (3072, 768)):
        line = []
        for m in (8, 16, 32, 48, 64, 65, 96, 128, 256):
            x, wq, scale, bias, bound = _k4_case(m, k, n, chip_smoke.SEED + m)
            fn = lambda: ops.int8_matmul(x, wq, scale, bias)  # noqa: E731
            # wide's own split-k at this m (plan gives wide past SKINNY_M).
            wide = _forced(
                quant, quant.plan(max(m, quant.SKINNY_M + 1), n, k, sms), fn)
            cell = f"m {m}: wide {wide:.5f}"
            if m <= quant.SKINNY_M:
                skinny = _forced(quant, quant.plan(m, n, k, sms), fn)
                cell += f", skinny {skinny:.5f}"
            line.append(cell + f" (bound {bound:.5f})")
        print(f"K4 skinny/wide threshold, k {k} n {n}, device ms: "
              + "; ".join(line) + f" [{card}]")


def k8_sweeps(card):
    import torch
    fused = importlib.import_module("np_modeling_tpu_torch.ops.fused")
    rng = np.random.default_rng(chip_smoke.SEED + 8)
    default = fused.LN_BWD_BLOCKS_PER_SM
    try:
        for rows, d in LN_SHAPES:
            def rand(*shape):
                return torch.tensor(rng.standard_normal(shape),
                                    dtype=torch.float32, device="cuda")
            x, dz = rand(rows, d).bfloat16(), rand(rows, d).bfloat16()
            gamma = rand(d) * 0.1 + 1.0
            bound = chip_smoke._bound(chip_smoke._nbytes(x, dz, gamma, x)
                                      + 2 * d * 4, 0)[0]
            line = []
            for per_sm in (1, 2):
                fused.LN_BWD_BLOCKS_PER_SM = per_sm
                ms = _ms(lambda: fused.layer_norm_bwd_cuda(
                    x, gamma, dz, chip_smoke.LN_EPS))
                line.append(f"{per_sm} blocks an SM: {ms:.5f} "
                            f"({bound / ms:.1%})")
            print(f"K8 backward [{rows}, {d}] bf16: bound {bound:.5f} ms; "
                  + "; ".join(line) + f" [{card}]")
    finally:
        fused.LN_BWD_BLOCKS_PER_SM = default


def main():
    import torch
    if not torch.cuda.is_available():
        print("exp_torch_k4_k8: no CUDA device", file=sys.stderr)
        return 2
    card = _card()
    k4_sweeps(card)
    k8_sweeps(card)
    return 0


def times(package=None):
    """Device ms of K4 at K4_SHAPES and K8's backward at LN_SHAPES, one JSON
    line; the package from ``package`` (a tree's root) where given."""
    if package is not None:
        sys.path.insert(0, package)
    import torch
    if not torch.cuda.is_available():
        print("exp_torch_k4_k8: no CUDA device", file=sys.stderr)
        return 2
    from np_modeling_tpu_torch import ops
    from np_modeling_tpu_torch.ops import fused
    res = {"package": ops.__file__}
    for m, k, n in chip_smoke.K4_SHAPES:
        x, wq, scale, bias, _ = _k4_case(m, k, n, chip_smoke.SEED + 11)
        res[f"K4 [{m}, {k}] x [{k}, {n}]"] = [chip_smoke._device_ms(
            lambda: ops.int8_matmul(x, wq, scale, bias)) for _ in range(3)]
    rng = np.random.default_rng(chip_smoke.SEED + 8)
    for rows, d in LN_SHAPES:
        x = torch.tensor(rng.standard_normal((rows, d)), dtype=torch.float32,
                         device="cuda").bfloat16()
        dz = torch.tensor(rng.standard_normal((rows, d)), dtype=torch.float32,
                          device="cuda").bfloat16()
        gamma = torch.ones(d, device="cuda")
        res[f"K8 backward [{rows}, {d}]"] = [chip_smoke._device_ms(
            lambda: fused.layer_norm_bwd_cuda(x, gamma, dz, chip_smoke.LN_EPS))
            for _ in range(3)]
    print(json.dumps(res))
    return 0


def parent_ab(parent):
    """``times`` in four processes: ``parent``, this tree, this tree,
    ``parent``; prints each shape's medians and this tree over ``parent``."""
    runs = []
    for package in (parent, None, None, parent):
        cmd = [sys.executable, __file__, "--times"]
        cmd += [] if package is None else ["--package", package]
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"{cmd} failed:\n{out.stderr}")
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    card = _card()
    for name in runs[0]:
        if name == "package":
            continue
        old = sorted(runs[0][name] + runs[3][name])
        new = sorted(runs[1][name] + runs[2][name])
        mid = len(old) // 2
        print(f"{name}: {parent} {' '.join(f'{t:.5f}' for t in old)} ms; "
              f"this tree {' '.join(f'{t:.5f}' for t in new)} ms; medians "
              f"{old[mid]:.5f} / {new[mid]:.5f}, this tree "
              f"{new[mid] / old[mid]:.3f}x (order old, new, new, old) "
              f"[{card}]")
    return 0


# A phase's cut: the source line it replaces (once) and the replacement,
# which skips the phase where its bit of SKIP is set.
K4_CUTS = [
    ("  cluster_sync();  // every rank's partial is in its shared memory",
     "  if (SKIP & 1) __syncthreads(); else cluster_sync();"),
    ("      if (r < ranks) v[r] = ld_rank(base + 4 * e, r);",
     "      if (r < ranks) v[r] = ld_rank(base + 4 * e, (SKIP & 1) ? rank : r);"),
    ("  cluster_sync();  // no block leaves while another reads its shared memory",
     "  if (!(SKIP & 1)) cluster_sync();"),
    ("      wg::cp_async16(wg::smem_u32(dst), in ? src : w, in ? 16 : 0);",
     "      if (!(SKIP & 2)) wg::cp_async16(wg::smem_u32(dst), in ? src : w, in ? 16 : 0);"),
    ("      mma(acc[j][0], a[0], b0, b1);\n      mma(acc[j][1], a[1], b0, b1);",
     "      if (!(SKIP & 4)) {\n        mma(acc[j][0], a[0], b0, b1);\n"
     "        mma(acc[j][1], a[1], b0, b1);\n      }"),
    ("                                              const float (&sc)[16]) {\n",
     "                                              const float (&sc)[16]) {\n"
     "  if (SKIP & 8) return;\n"),
    ("        wg::mbar_expect_tx(&full[s], kStageBytes);",
     "        wg::mbar_expect_tx(&full[s], (SKIP & 16) ? kXBytes : kStageBytes);"),
    ("        wg::tma_load_2d(stage + kXBytes, &mw, &full[s], tn * kBN, kk);",
     "        if (!(SKIP & 16)) wg::tma_load_2d(stage + kXBytes, &mw, &full[s], tn * kBN, kk);"),
    ("      for (int j = 0; j < kSlice / 16; ++j)\n        wg::wgmma_ss<0, 1>(",
     "      for (int j = 0; j < ((SKIP & 32) ? 0 : kSlice / 16); ++j)\n"
     "        wg::wgmma_ss<0, 1>("),
]
K4_VARIANTS = {"whole kernel": 0,
               "skinny without the cluster exchange (own partial only)": 1,
               "skinny without its weight copy": 2,
               "skinny without its products": 4,
               "wide without the dequantizing conversion": 8,
               "wide without the int8 weight's TMA loads": 16,
               "wide without the conversion and the weight's loads": 24,
               "wide without wgmma": 32}
K8_CUTS = [
    ("        store_vec<T, V>(dx + row * d + col, o);",
     "        if (!(SKIP & 1)) store_vec<T, V>(dx + row * d + col, o);"),
    ("  ln_bwd_reduce<<<(2 * d + 31) / 32, kReduceWarps * 32, 0, stream>>>(part, sums, n_blocks, d);",
     "  if (!(SKIP & 2))\n    ln_bwd_reduce<<<(2 * d + 31) / 32, kReduceWarps * 32, 0, stream>>>(\n"
     "        part, sums, n_blocks, d);"),
    ("  for (int which = 0; which < 2; ++which) {",
     "  for (int which = 0; which < ((SKIP & 4) ? 0 : 2); ++which) {"),
    # One row in flight a warp: each row copied when it is reduced.
    ("  if (kAsync && row < n) issue(row, 0);",
     "  if (kAsync && row < n && !(SKIP & 8)) issue(row, 0);"),
    ("      if (row + stride < n) issue(row + stride, slot ^ 1);",
     "      if (SKIP & 8) issue(row, slot);\n"
     "      else if (row + stride < n) issue(row + stride, slot ^ 1);"),
    ("      wg::cp_async_wait<1>();  // this row's copies have landed",
     "      if (SKIP & 8) wg::cp_async_wait<0>();\n"
     "      else wg::cp_async_wait<1>();"),
]
K8_VARIANTS = {"whole kernel": 0, "without the dx stores": 1,
               "without the final reduce kernel": 2,
               "without the block's partial sums": 4,
               "without both reduces": 6,
               "one row in flight a warp": 8}


def _build_variants(out, name, cuts, variants):
    """One library a variant of csrc/<name>.cu under ``out``, in parallel."""
    from np_modeling_tpu_torch.ops import cuda_build
    src = (cuda_build.CSRC / f"{name}.cu").read_text()
    for old, new in cuts:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}.cu no longer holds {old!r}")
        src = src.replace(old, new)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cu").write_text(src)
    for h in cuda_build.CSRC.glob("*.cuh"):
        (out / h.name).write_text(h.read_text())
    return {bits: subprocess.Popen(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, f"-DSKIP={bits}", "-o",
         str(out / f"{name}_{bits}.so"), str(out / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for bits in variants.values()}


def _loaded(out, name, bits, fn_name, argtypes):
    import ctypes
    fn = getattr(ctypes.CDLL(str(out / f"{name}_{bits}.so")), fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def phases():
    """Each variant's device ms beside the whole kernel's (see the module
    docstring)."""
    import ctypes
    import torch
    if not torch.cuda.is_available():
        print("exp_torch_k4_k8: no CUDA device", file=sys.stderr)
        return 2
    from np_modeling_tpu_torch.ops import fused
    quant = importlib.import_module("np_modeling_tpu_torch.ops.quantization")
    out = chip_smoke.HERE / "build" / "exp_k4_k8_phases"
    procs = {**{("int8_matmul", b): p for b, p in _build_variants(
        out, "int8_matmul", K4_CUTS, K4_VARIANTS).items()},
        **{("fused", b): p for b, p in _build_variants(
            out, "fused", K8_CUTS, K8_VARIANTS).items()}}
    for key, proc in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed ({key}):\n{log}")
    card = _card()
    stream = torch.cuda.current_stream().cuda_stream
    argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    for m, k, n in chip_smoke.K4_SHAPES:
        x, wq, scale, bias, bound = _k4_case(m, k, n, chip_smoke.SEED + 11)
        p = quant.plan(m, n, k, fused.sm_count("cuda"))
        y = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
        ws = torch.empty(p.splits, m, n, device="cuda") if p.splits > 1 \
            and p.schedule == "wide" else None
        scale = scale.reshape(n).contiguous()
        line = []
        for name, bits in K4_VARIANTS.items():
            if (name.startswith("skinny") and p.schedule != "skinny") or (
                    name.startswith("wide") and p.schedule != "wide"):
                continue
            fn = _loaded(out, "int8_matmul", bits, "np_int8_matmul", argtypes)

            def call(fn=fn):
                rc = fn(x.data_ptr(), wq.data_ptr(), scale.data_ptr(),
                        bias.data_ptr(), y.data_ptr(),
                        ws.data_ptr() if ws is not None else None, 1, 1, m, n,
                        k, {"skinny": 1, "wide": 2}[p.schedule], p.n_tile,
                        p.splits, stream)
                if rc:
                    raise RuntimeError(f"launch failed: CUDA error {rc}")

            line.append(f"{name} {_ms(call):.5f}")
        print(f"K4 {p.schedule} {tuple(p)} [{m}, {k}] x [{k}, {n}]: bound "
              f"{bound:.5f} ms; device ms: " + "; ".join(line) + f" [{card}]")
    rng = np.random.default_rng(chip_smoke.SEED + 8)
    for rows, d in LN_SHAPES:
        x = torch.tensor(rng.standard_normal((rows, d)), dtype=torch.float32,
                         device="cuda").bfloat16()
        dz = torch.tensor(rng.standard_normal((rows, d)), dtype=torch.float32,
                          device="cuda").bfloat16()
        gamma = torch.ones(d, device="cuda")
        dx = torch.empty_like(x)
        t_row, blocks = fused.ln_bwd_plan(rows, d, fused.sm_count("cuda"))
        part = torch.empty(2, blocks, d, device="cuda")
        sums = torch.empty(2, d, device="cuda")
        bound = chip_smoke._bound(chip_smoke._nbytes(x, dz, gamma, x)
                                  + 2 * d * 4, 0)[0]
        line = []
        for name, bits in K8_VARIANTS.items():
            fn = _loaded(out, "fused", bits, "np_layer_norm_bwd",
                         fused._ARGTYPES["np_layer_norm_bwd"]
                         + [ctypes.c_void_p])

            def call(fn=fn):
                rc = fn(x.data_ptr(), gamma.data_ptr(), dz.data_ptr(),
                        dx.data_ptr(), part.data_ptr(), sums.data_ptr(), 1,
                        rows, d, t_row, blocks, chip_smoke.LN_EPS, stream)
                if rc:
                    raise RuntimeError(f"launch failed: CUDA error {rc}")

            line.append(f"{name} {_ms(call):.5f}")
        parts = chip_smoke._kernel_split_ms(
            lambda: fused.layer_norm_bwd_cuda(x, gamma, dz, chip_smoke.LN_EPS),
            ("layer_norm_bwd_warp", "ln_bwd_reduce"))
        print(f"K8 backward [{rows}, {d}] bf16 ({blocks} blocks): bound "
              f"{bound:.5f} ms; device ms: " + "; ".join(line)
              + f"; by the profiler {parts} [{card}]")
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    if args[:1] == ["--phases"]:
        sys.exit(phases())
    if args[:1] == ["--parent-ab"]:
        sys.exit(parent_ab(args[1]))
    if args[:1] == ["--times"]:
        sys.exit(times(args[2] if args[1:2] == ["--package"] else None))
    sys.exit(main())
