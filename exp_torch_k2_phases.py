"""Where the fused flash backward K2 spends its time on the card: K2 (bf16,
head_dim 128, causal, no options) at the bench shape b4 h8 s4096, built again
with one phase of its loop left out at a time, each variant timed beside the
whole kernel. The variants compute wrong gradients by design; they only bound
what each phase costs.

    python3 exp_torch_k2_phases.py

Builds copies of np_modeling_tpu_torch/csrc/flash_attention.cu with one K2
instantiation each under build/exp_k2_phases/ (one nvcc a variant, all
started together), times each with CUDA events (two readings of 20 launches
after 3), and prints one line a variant, then the whole wrapper (di, the
zeroed fp32 dq and its cast included), each with the card's name and power
limit. Needs a CUDA card and nvcc; it fails loudly where the kernel's source
no longer holds a phase it cuts.
"""

from __future__ import annotations

import ctypes
import math
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
SHAPE = (4, 8, 4096, 128)          # b, h, s, d: the bench GPT's attention
# A phase's cut: the source it replaces (once) and the replacement, which
# skips the phase where its bit of SKIP is set.
CUTS = [
    ("    issue(it + S::kStages - 1);",
     "    if (!(SKIP & 8)) issue(it + S::kStages - 1);\n"
     "    else wg::cp_async_commit();"),
    ("          pe[e] = expf(x - lse_s[ql]);",
     "          pe[e] = (SKIP & 4) ? x : expf(x - lse_s[ql]);"),
    ("      rs_stage(dv, ap, do_s, 0);",
     "      if (!(SKIP & 16)) rs_stage(dv, ap, do_s, 0);"),
    ("      rs_stage(dk, ads, q_s, 0);",
     "      if (!(SKIP & 16)) rs_stage(dk, ads, q_s, 0);"),
    ("        dq_pass<D, NQ, KV>(",
     "        if (!(SKIP & 1)) dq_pass<D, NQ, KV>("),
    ("      if (row < p.sq)\n        atomicAdd(",
     "      if (!(SKIP & 2) && row < p.sq)\n        atomicAdd("),
]
VARIANTS = {"whole kernel": 0, "without the dq pass": 1,
            "without dq's atomics": 2, "without exp": 4,
            "without the next tile's loads": 8, "without dv and dk": 16,
            "without dq, dv and dk": 17}
# One entry point: K2 at head_dim 128 without options, as
# np_flash_attention_bwd launches it.
ENTRY = r'''
extern "C" int k2_d128(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* di, void* dq, void* dk, void* dv,
                       const long long* strides, int b, int hq, int hkv, int sq, int skv,
                       float scale, void* stream) {
  Params p = make_params(strides, nullptr, nullptr, b, hq, hkv, sq, skv, 1, 0, scale, 0.f);
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse = const_cast<float*>(lse); p.di = di;
  p.dq = dq; p.dk = dk; p.dv = dv;
  using W = BwdSmem<128>;
  return launch(flash_bwd_bf16<128, true, 0>, dim3(b * hkv, (skv + W::kKv - 1) / W::kKv), 256,
                W::kBytes, static_cast<cudaStream_t>(stream), p);
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
    (out / "k2.cu").write_text(src + ENTRY)
    (out / "wgmma.cuh").write_text((cuda_build.CSRC / "wgmma.cuh").read_text())
    procs = {bits: subprocess.Popen(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, f"-DSKIP={bits}", "-o",
         str(out / f"k2_{bits}.so"), str(out / "k2.cu")],
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


def main():
    sys.path.insert(0, str(HERE))
    import torch
    from np_modeling_tpu_torch.ops import attention
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    out = HERE / "build" / "exp_k2_phases"
    build(out)
    b, h, s_len, d = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(b, h, s_len, d, generator=gen,
                               device="cuda").bfloat16() for _ in range(4))
    scale = 1 / math.sqrt(d)
    o, lse = attention._flash_fwd_cuda(q, k, v, True, scale, True)
    o = o.contiguous()
    di = (do.float() * o.float()).sum(-1).contiguous()
    dq = torch.zeros(b, s_len, h, d, device="cuda")
    dk = torch.empty(b, s_len, h, d, device="cuda", dtype=torch.bfloat16)
    dv = torch.empty_like(dk)
    strides = (ctypes.c_longlong * 16)(
        *[x for t in (q, k, v, do) for x in t.stride()[:3]], 0, 0, 0, 0)
    stream = torch.cuda.current_stream().cuda_stream

    calls = {}
    for name, bits in VARIANTS.items():
        fn = ctypes.CDLL(str(out / f"k2_{bits}.so")).k2_d128
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])

        def call(fn=fn):
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), strides, b, h, h, s_len,
                    s_len, scale, stream)
            if rc != 0:
                raise RuntimeError(f"launch failed: CUDA error {rc}")

        calls[name] = call
    calls["the whole wrapper (di, zeroed dq, its cast)"] = (
        lambda: attention._flash_bwd_cuda(q, k, v, o, lse, do, True, scale))
    times = {name: [] for name in calls}
    for _ in range(2):
        for name, call in calls.items():
            times[name].append(_timed(call))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    for name, t in times.items():
        print(f"K2 b{b} h{h} s{s_len} d{d} causal bf16, {name}: "
              f"{min(t):.4f} ms (readings "
              f"{', '.join(f'{x:.4f}' for x in t)}) [{card}]")


if __name__ == "__main__":
    main()
