"""K10 (the stochastic int8 quantizer) on one CUDA card: its device time
under other plans, with one phase cut at a time, and beside an older tree's
kernel.

    python3 exp_torch_k10.py
    python3 exp_torch_k10.py --phases
    python3 exp_torch_k10.py --parent-ab DIR

The first form sweeps, at SWEEP_SHAPES (SHAPES and three row lengths about
where rows gives way to block_row; seeded inputs on the card), the rows
schedule over lanes a row (1..32) and warps a block (1..16), then over
blocks an SM (a grid that walks the rows) at the plan's own lanes and
warps, and the block_row schedule over threads a block and blocks an SM;
the simple schedule (the port's first K10 kernel) beside them. The
walking grids run on a variant of csrc/quantize.cu built under
build/exp_k10_walk/ (K10_WALK), whose outputs are checked equal to the
port's kernel's at every grid. Each line
marks the plan's own choice and gives the bound (chip_smoke's _bound: x,
the int8 values and the fp32 scales over 3.35 TB/s) and its share.

The second form builds copies of csrc/quantize.cu under
build/exp_k10_phases/ with one phase left out at a time (one nvcc a
variant, all started together; a variant computes wrong outputs by design,
it only bounds what the phase costs) and times each beside the whole
kernel at the plan's own schedule: without the Philox draws (the counter
itself in their place), without the exact fallback (the
IEEE divisions of the vectors near a rounding boundary; wrong there),
without the int8 stores (a store only where a packed word equals a value
it never takes, so the work stays live), without the absmax reduction (no
shuffles, no barrier), and the loads with the fast rounding alone (all of
these at once). It fails loudly where the source no longer holds a phase
it cuts.

    python3 exp_torch_k10.py --sass

prints, for the kernel the plan launches at each shape of SHAPES, the
static instruction count of its SASS (`cuobjdump -sass` of the built
library) by opcode, and that count over the elements a thread rounds in a
row (P vectors of V): the issue cost of an element, to within the loop
and the slow paths that run rarely.

The fourth form times K10 at SHAPES in four processes: the tree in DIR (an
unpacked older checkout, e.g. ``git archive <commit> | tar -x -C
build/parent``, whose package has the same ``ops.quantize_int8_stochastic``),
this tree, this tree, DIR, each on the same seeded inputs, and prints each
side's device ms and their ratio. ``--times [--package DIR]`` is one such
process.

A report, not a check; it imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import subprocess
import sys

import chip_smoke
from exp_torch_k4_k8 import _build_variants, _card, _loaded, _ms

# (n, d, dtype): the rows schedule's main shapes ([8192, 768] fp32 is
# chip_smoke (m)'s; bf16 the GPT-2 step's hidden states, (l); [21504, 64]
# bf16 the per-head rows of a GPT-2 prefill chunk, (c); Gemma-2 2B's
# width), a long row (block_row) and a ragged one (simple).
SHAPES = ((8192, 768, "float32"), (8192, 768, "bfloat16"),
          (21504, 64, "bfloat16"), (8192, 2304, "bfloat16"),
          (1024, 16384, "float32"), (8192, 1001, "float32"))
# The sweep also times rows against block_row where rows end (8 vectors a
# lane of 32: d 1024 fp32, 2048 bf16) and past it, and the short per-head
# rows of other head dims and dtypes (d 128 and 256 bf16, d 64 fp32).
SWEEP_SHAPES = SHAPES + ((8192, 1024, "float32"), (8192, 1536, "float32"),
                         (8192, 2048, "bfloat16"), (21504, 128, "bfloat16"),
                         (21504, 256, "bfloat16"), (21504, 64, "float32"))
SEED = 12345


def _case(n, d, dtype):
    """Seeded x [n, d] on the card, and its bound in ms."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + d)
    x = torch.randn(n, d, generator=g, device="cuda").to(getattr(torch, dtype))
    nbytes = chip_smoke._nbytes(x) + n * d + 4 * n
    return x, chip_smoke._bound(nbytes, 0)[0]


def _cell(ms, bound, mark=""):
    return f"{ms:.5f} ({bound / ms:.0%}{mark})"


def _launcher(fn, x, p, grid=None):
    """A call of the library function ``fn`` (np_quantize_int8_stochastic
    of a built variant) on ``x`` under plan ``p``, ``grid`` blocks where
    given; its outputs are the call's attributes ``values`` and ``scales``.
    """
    import torch
    quant = importlib.import_module("np_modeling_tpu_torch.ops.quantization")
    n, d = x.shape
    values = torch.empty(n, d, dtype=torch.int8, device="cuda")
    scales = torch.empty(n, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = fn(x.data_ptr(), values.data_ptr(), scales.data_ptr(),
                quant._X_CODES[x.dtype], n, d, SEED,
                quant._QUANT_SCHEDULES[p.schedule], p.vec, p.lanes,
                p.per_lane, p.warps, grid or p.grid, stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")

    call.values, call.scales = values, scales
    return call


# The walk variant: rows and block_row step through the rows at the grid's
# stride (block_row with a second barrier a row, so the next row's maxima
# wait for this row's reads), and the library takes a grid that does not
# cover every row. The sweep's blocks-an-SM grids run on it; the port's
# kernels cover each row once.
K10_WALK = [
    ("  const long long row =\n"
     "      (static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + "
     "threadIdx.x / 32) * (32 >> shift) +\n"
     "      (lane >> shift);\n",
     "  for (long long row =\n"
     "      (static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + "
     "threadIdx.x / 32) * (32 >> shift) +\n"
     "      (lane >> shift);\n"
     "       row - (lane >> shift) < n;\n"
     "       row += static_cast<long long>(gridDim.x) * blockDim.x >> shift) "
     "{\n"),
    ("  if (!live) return;\n", "  if (!live) continue;\n"),
    ("  round_row(v, rs, row, d, gl, lanes, nv, values, rk);\n}",
     "  round_row(v, rs, row, d, gl, lanes, nv, values, rk);\n  }\n}"),
    ("  const long long row = blockIdx.x;\n  Vec<T, V> v[P];\n",
     "  for (long long row = blockIdx.x; row < n; row += gridDim.x) {\n"
     "  Vec<T, V> v[P];\n"),
    ("  round_row(v, rs, row, d, threadIdx.x, blockDim.x, nv, values, rk);"
     "\n}",
     "  round_row(v, rs, row, d, threadIdx.x, blockDim.x, nv, values, rk);"
     "\n  __syncthreads();\n  }\n}"),
    ("      static_cast<long long>(grid) * (schedule == 1 ? warps * "
     "(32 / lanes) : 1) >= n;", "      true;"),
]


def sweep(card):
    import torch
    from np_modeling_tpu_torch import ops
    from np_modeling_tpu_torch.ops.fused import sm_count
    quant = importlib.import_module("np_modeling_tpu_torch.ops.quantization")
    sms = sm_count("cuda")
    out = chip_smoke.HERE / "build" / "exp_k10_walk"
    (proc,) = _build_variants(out, "quantize", K10_WALK, {"walk": 0}).values()
    log = proc.communicate()[0].decode()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed (walk):\n{log}")
    walk = _loaded(out, "quantize", 0, "np_quantize_int8_stochastic",
                   _ARGTYPES)
    for n, d, dtype in SWEEP_SHAPES:
        x, bound = _case(n, d, dtype)
        tdtype = getattr(torch, dtype)
        own = quant.quantize_plan(n, d, tdtype, True, sms)
        call = lambda: ops.quantize_int8_stochastic(x, SEED)  # noqa: E731
        want = call()

        def forced(schedule, **knobs):
            with chip_smoke._k10_schedule(schedule, **knobs):
                p = quant._cached_quantize_plan(n, d, tdtype, True, 0)
                return p, _ms(call)

        def walked(p, per_sm):
            run = _launcher(walk, x, p, min(p.grid, per_sm * sms))
            ms = _ms(run)
            if not (torch.equal(run.values, want.values.view(n, d))
                    and torch.equal(run.scales, want.scales.view(n))):
                raise AssertionError(f"walk {tuple(p)} x {per_sm}: not the "
                                     f"port's kernel's outputs")
            return min(p.grid, per_sm * sms), ms

        line = [f"plan {tuple(own)} {_cell(_ms(call), bound)}"]
        _, ms = forced("simple")
        line.append(f"simple {_cell(ms, bound)}")
        if own.schedule != "simple":
            cells = []
            for lanes in (1, 2, 4, 8, 16, 32):
                for warps in (1, 2, 4, 8, 16):
                    try:
                        p, ms = forced("rows", lanes=lanes, warps=warps)
                    except ValueError:
                        break
                    mark = ", the plan" if p == own else ""
                    cells.append(f"{lanes}x{warps} {_cell(ms, bound, mark)}")
            line.append("rows lanes x warps: " + "; ".join(cells))
        if own.schedule == "rows":
            cells = []
            for per_sm in (1, 2, 4, 8, 16, 32):
                grid, ms = walked(own, per_sm)
                cells.append(f"{per_sm} ({grid} blocks) {_cell(ms, bound)}")
            line.append(f"rows at {own.lanes}x{own.warps}, blocks an SM "
                        f"walking the rows: " + "; ".join(cells))
        if own.schedule != "simple":
            cells = []
            for threads in (128, 256, 288, 512):
                try:
                    p, ms = forced("block_row", lanes=threads)
                except ValueError:
                    continue
                mark = ", the plan" if p == own else ""
                cells.append(f"{threads} x all {_cell(ms, bound, mark)}")
                for per_sm in (1, 2, 4, 8):
                    _, ms = walked(p, per_sm)
                    cells.append(f"{threads} x {per_sm} {_cell(ms, bound)}")
            line.append("block_row threads x blocks an SM: "
                        + "; ".join(cells))
        print(f"K10 [{n}, {d}] {dtype}: bound {bound:.5f} ms; device ms "
              f"(share of the bound): " + " | ".join(line) + f" [{card}]")
        del x, want
        torch.cuda.empty_cache()


def main():
    import torch
    if not torch.cuda.is_available():
        print("exp_torch_k10: no CUDA device", file=sys.stderr)
        return 2
    sweep(_card())
    return 0


def times(package=None):
    """Device ms of K10 at SHAPES, one JSON line; the package from
    ``package`` (a tree's root) where given."""
    if package is not None:
        sys.path.insert(0, package)
    import torch
    if not torch.cuda.is_available():
        print("exp_torch_k10: no CUDA device", file=sys.stderr)
        return 2
    from np_modeling_tpu_torch import ops
    res = {"package": ops.__file__}
    for n, d, dtype in SHAPES:
        x, _ = _case(n, d, dtype)
        res[f"K10 [{n}, {d}] {dtype}"] = [chip_smoke._device_ms(
            lambda: ops.quantize_int8_stochastic(x, SEED)) for _ in range(3)]
        del x
    print(json.dumps(res))
    return 0


def parent_ab(parent):
    """``times`` in four processes: ``parent``, this tree, this tree,
    ``parent``; prints each shape's readings, medians and this tree over
    ``parent``, beside the bound."""
    runs = []
    for package in (parent, None, None, parent):
        cmd = [sys.executable, __file__, "--times"]
        cmd += [] if package is None else ["--package", package]
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"{cmd} failed:\n{out.stderr}")
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    card = _card()
    for n, d, dtype in SHAPES:
        name = f"K10 [{n}, {d}] {dtype}"
        bound = chip_smoke._bound(
            n * d * (4 if dtype == "float32" else 2) + n * d + 4 * n, 0)[0]
        old = sorted(runs[0][name] + runs[3][name])
        new = sorted(runs[1][name] + runs[2][name])
        mid = len(old) // 2
        print(f"{name}: {parent} {' '.join(f'{t:.5f}' for t in old)} ms; "
              f"this tree {' '.join(f'{t:.5f}' for t in new)} ms; medians "
              f"{old[mid]:.5f} / {new[mid]:.5f} ({bound / old[mid]:.0%} / "
              f"{bound / new[mid]:.0%} of the bound {bound:.5f}), this tree "
              f"{new[mid] / old[mid]:.3f}x (order old, new, new, old) "
              f"[{card}]")
    return 0


# A phase's cut: the source text it replaces (once) and the replacement,
# which skips the phase where its bit of SKIP is set.
K10_CUTS = [
    ("  for (int r = 0; r < 10; ++r) {\n    const uint32_t lo0",
     "  for (int r = 0; r < ((SKIP & 1) ? 0 : 10); ++r) {\n    const uint32_t lo0"),
    ("  if (exact) {", "  if (!(SKIP & 2) && exact) {"),
    ("  if constexpr (V == 4)\n",
     "  if ((SKIP & 4) && packed[0] != __float_as_uint(rs.scale)) return;\n"
     "  if constexpr (V == 4)\n"),
    ("  for (int off = lanes >> 1; off > 0; off >>= 1)",
     "  for (int off = (SKIP & 8) ? 0 : lanes >> 1; off > 0; off >>= 1)"),
    ("  for (int off = 16; off > 0; off >>= 1)\n"
     "    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));\n"
     "  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = amax;\n"
     "  __syncthreads();\n  amax = red[0];\n  for (int w = 1; w < warps;",
     "  for (int off = (SKIP & 8) ? 0 : 16; off > 0; off >>= 1)\n"
     "    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));\n"
     "  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = amax;\n"
     "  if (!(SKIP & 8)) __syncthreads();\n  amax = red[0];\n"
     "  for (int w = 1; w < warps;"),
]
K10_VARIANTS = {"whole kernel": 0, "without the Philox draws": 1,
                "without the exact fallback": 2, "without the int8 stores": 4,
                "without the absmax reduction": 8,
                "without the draws and the fallback": 3,
                "the loads and the fast rounding alone": 15}
_ARGTYPES = [ctypes.c_void_p] * 3 + [
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint64] + [
    ctypes.c_int] * 6 + [ctypes.c_void_p]


def phases():
    """Each variant's device ms beside the whole kernel's (see the module
    docstring)."""
    import torch
    if not torch.cuda.is_available():
        print("exp_torch_k10: no CUDA device", file=sys.stderr)
        return 2
    from np_modeling_tpu_torch.ops.fused import sm_count
    quant = importlib.import_module("np_modeling_tpu_torch.ops.quantization")
    out = chip_smoke.HERE / "build" / "exp_k10_phases"
    procs = _build_variants(out, "quantize", K10_CUTS, K10_VARIANTS)
    for bits, proc in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed (SKIP={bits}):\n{log}")
    card = _card()
    sms = sm_count("cuda")
    for n, d, dtype in SHAPES:
        x, bound = _case(n, d, dtype)
        p = quant.quantize_plan(n, d, getattr(torch, dtype), True, sms)
        if p.schedule == "simple":
            continue
        line = []
        for name, bits in K10_VARIANTS.items():
            fn = _loaded(out, "quantize", bits, "np_quantize_int8_stochastic",
                         _ARGTYPES)
            line.append(f"{name} {_cell(_ms(_launcher(fn, x, p)), bound)}")
        print(f"K10 {tuple(p)} [{n}, {d}] {dtype}: bound {bound:.5f} ms; "
              f"device ms (share of the bound): " + "; ".join(line)
              + f" [{card}]")
        del x
    return 0


def _mangled(p, tdtype):
    """The mangled-name fragment of the plan's kernel instantiation."""
    import torch
    t = "f" if tdtype == torch.float32 else "13__nv_bfloat16"
    name = {"rows": "quantize_rows", "block_row": "quantize_block_row"}
    kernel = name[p.schedule]
    return f"{len(kernel)}{kernel}I{t}Li{p.vec}ELi{p.per_lane}E"


def sass():
    """Opcode counts of the plan's kernels (see the module docstring)."""
    import collections
    import os
    import re
    import torch
    from torch.utils.cpp_extension import CUDA_HOME
    from np_modeling_tpu_torch.ops import cuda_build
    if not torch.cuda.is_available():
        print("exp_torch_k10: no CUDA device", file=sys.stderr)
        return 2
    quant = importlib.import_module("np_modeling_tpu_torch.ops.quantization")
    lib = cuda_build.load("quantize")
    dump = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", str(lib.path)],
        capture_output=True, text=True, check=True).stdout
    functions = {f.split("\n", 1)[0].strip(): f
                 for f in re.split(r"\n\s*Function : ", dump)[1:]}
    for n, d, dtype in SHAPES:
        tdtype = getattr(torch, dtype)
        p = quant.quantize_plan(n, d, tdtype, True, 132)
        if p.schedule == "simple":
            continue
        frag = _mangled(p, tdtype)
        (name,) = [k for k in functions if frag in k]
        ops = collections.Counter(
            m.group(1) for m in re.finditer(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)",
                functions[name]))
        total = sum(ops.values())
        print(f"K10 {tuple(p)} [{n}, {d}] {dtype}: {total} SASS instructions, "
              f"{total / (p.per_lane * p.vec):.1f} an element of a thread's "
              f"row; " + ", ".join(f"{k} {v}" for k, v in ops.most_common(24)))
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    if args[:1] == ["--sass"]:
        sys.exit(sass())
    if args[:1] == ["--phases"]:
        sys.exit(phases())
    if args[:1] == ["--parent-ab"]:
        sys.exit(parent_ab(args[1]))
    if args[:1] == ["--times"]:
        sys.exit(times(args[2] if args[1:2] == ["--package"] else None))
    sys.exit(main())
