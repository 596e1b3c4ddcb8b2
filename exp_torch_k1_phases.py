"""Where the flash forward K1 spends its time on the card: K1 (bf16, causal)
at the bench shape (b4 h8 s4096 d128, no options) and at Gemma-2's global
layer (b1 hq8 hkv4 s8192 d256, softcap 50), built again with one phase of its
loop left out at a time, each variant timed beside the whole kernel. The
variants compute wrong outputs by design; they only bound what each phase
costs. Then K12 beside K1 at the bench shape, causal and full (no mask
work and an even tile count: what K12's schedule itself costs).

    python3 exp_torch_k1_phases.py

Builds copies of np_modeling_tpu_torch/csrc/flash_attention.cu with the two
K1 instantiations and K12 at d128 under build/exp_k1_phases/ (one nvcc a variant, all
started together), times each with CUDA events (two readings of 20 launches
after 3), and prints one line a variant and shape, with the card's name and
power limit. Needs a CUDA card and nvcc; it fails loudly where the kernel's
source no longer holds a phase it cuts.
"""

from __future__ import annotations

import ctypes
import math
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
SHAPES = {"bench b4 h8 s4096 d128": ((4, 8, 8, 4096, 128), 0.0),
          "gemma2 global b1 hq8 hkv4 s8192 d256 softcap 50": (
              (1, 8, 4, 8192, 256), 50.0)}
# A phase's cut: the source it replaces (once) and the replacement, which
# skips the phase where its bit of SKIP is set.
CUTS = [
    ("      s[i] = wg::exp2_approx(fmaf(s[i], c, -mb[(i >> 1) & 1]));",
     "      s[i] = (SKIP & 1) ? fmaf(s[i], c, -mb[(i >> 1) & 1])\n"
     "                        : wg::exp2_approx(fmaf(s[i], c, -mb[(i >> 1) & 1]));"),
    ("      s[i] = wg::exp2_approx((s[i] - m[(i >> 1) & 1]) * kLog2e);",
     "      s[i] = (SKIP & 1) ? (s[i] - m[(i >> 1) & 1]) * kLog2e\n"
     "                        : wg::exp2_approx((s[i] - m[(i >> 1) & 1]) * kLog2e);"),
    ("      if constexpr ((kOpt & kOptCap) != 0) x = p.softcap * tanhf(x * p.inv_softcap);",
     "      if constexpr ((kOpt & kOptCap) != 0)\n"
     "        x = (SKIP & 2) ? x : p.softcap * tanhf(x * p.inv_softcap);"),
    ("      fwd_softmax<R, kOpt>(p, s, pa, m, l, alpha, edge_of(kv0), row0,",
     "      fwd_softmax<R, kOpt>(p, s, pa, m, l, alpha, (SKIP & 4) ? false : edge_of(kv0), row0,"),
    ("      scale_o<D>(o, alpha);\n      wg::mbar_wait(&v_full[slot], parity);",
     "      if (!(SKIP & 8)) scale_o<D>(o, alpha);\n"
     "      wg::mbar_wait(&v_full[slot], parity);"),
    ("      fwd_pv<D>(o, pa, v_s + slot * S::kKvBytes);",
     "      if (!(SKIP & 16)) fwd_pv<D>(o, pa, v_s + slot * S::kKvBytes);"),
]
VARIANTS = {"whole kernel": 0, "without exp": 1, "without the cap's tanh": 2,
            "without the mask (edge tiles as interior)": 4,
            "without the rescale of o": 8, "without p.v": 16,
            "without exp, tanh, the mask and the rescale": 15}
# K1 at head_dim 128 without options and at 256 with the softcap, as
# np_flash_attention_fwd launches them.
ENTRY = r'''
extern "C" int k1(const void* q, const void* k, const void* v, void* o, float* lse,
                  const long long* strides, int b, int hq, int hkv, int sq, int skv, int d,
                  float scale, float softcap, int causal, int dual, void* stream) {
  Params p = make_params(strides, nullptr, nullptr, b, hq, hkv, sq, skv, causal, 0, scale,
                         softcap);
  p.q = q; p.k = k; p.v = v; p.o = o; p.lse = lse;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dual) return launch_fwd_bf16<128, 2, 0>(p, s);
  return d == 128 ? launch_fwd_bf16<128, 1, 0>(p, s) : launch_fwd_bf16<256, 1, kOptCap>(p, s);
}
'''


def build(out):
    """One library a variant under ``out``, built in parallel."""
    from np_modeling_tpu_torch.ops import cuda_build
    src = (cuda_build.CSRC / "flash_attention.cu").read_text()
    src = src[:src.index('extern "C" int np_flash_attention_fwd')]
    for old, new in CUTS:
        if src.count(old) != 1:
            raise RuntimeError(f"the kernel no longer holds {old!r}")
        src = src.replace(old, new)
    out.mkdir(parents=True, exist_ok=True)
    (out / "k1.cu").write_text(src + ENTRY)
    (out / "wgmma.cuh").write_text((cuda_build.CSRC / "wgmma.cuh").read_text())
    procs = {bits: subprocess.Popen(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, f"-DSKIP={bits}", "-o",
         str(out / f"k1_{bits}.so"), str(out / "k1.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for bits in VARIANTS.values()}
    for bits, proc in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed (SKIP={bits}):\n{log}")


def _timed(fn, runs=20):
    """Milliseconds a call of ``fn``, CUDA events around ``runs`` calls."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def _call(fn, q, k, v, o, lse, strides, softcap, causal, dual, stream):
    """One launch of ``fn`` (an entry point of a variant) on these tensors."""
    b, hq, s_len, d = q.shape
    hkv = k.shape[1]

    def call():
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), strides, b, hq, hkv, s_len, s_len, d,
                1 / math.sqrt(d), softcap, causal, dual, stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")

    return call


def main():
    sys.path.insert(0, str(HERE))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    out = HERE / "build" / "exp_k1_phases"
    build(out)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    fns = {}
    for bits in VARIANTS.values():
        fn = ctypes.CDLL(str(out / f"k1_{bits}.so")).k1
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fns[bits] = fn
    for shape_name, ((b, hq, hkv, s_len, d), softcap) in SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(0)
        q = torch.randn(b, hq, s_len, d, generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn(b, hkv, s_len, d, generator=gen,
                            device="cuda").bfloat16() for _ in range(2))
        o = torch.empty(b, s_len, hq, d, device="cuda", dtype=torch.bfloat16)
        lse = torch.empty(b, hq, s_len, device="cuda")
        strides = (ctypes.c_longlong * 16)(
            *[x for t in (q, k, v) for x in t.stride()[:3]], *([0] * 7))
        stream = torch.cuda.current_stream().cuda_stream
        times = {name: [] for name in VARIANTS}
        for _ in range(2):
            for name, bits in VARIANTS.items():
                times[name].append(_timed(_call(
                    fns[bits], q, k, v, o, lse, strides, softcap, 1, 0, stream)))
        for name, t in times.items():
            print(f"K1 {shape_name} causal bf16, {name}: {min(t):.4f} ms "
                  f"(readings {', '.join(f'{x:.4f}' for x in t)}) [{card}]")
        if d != 128:
            continue
        for causal in (1, 0):
            t = {"K1": [], "K12": []}
            for _ in range(2):
                for kernel, dual in (("K1", 0), ("K12", 1), ("K12", 1), ("K1", 0)):
                    t[kernel].append(_timed(_call(fns[0], q, k, v, o, lse, strides,
                                                  softcap, causal, dual, stream)))
            print(f"K12 beside K1, {shape_name} {'causal' if causal else 'full'} "
                  f"bf16: K12 {min(t['K12']):.4f} ms, K1 {min(t['K1']):.4f} ms, "
                  f"{min(t['K12']) / min(t['K1']):.3f}x (order K1, K12, K12, K1, "
                  f"twice) [{card}]")


if __name__ == "__main__":
    main()
