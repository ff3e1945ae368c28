#!/usr/bin/env python3
"""What bounds the bias-GELU "vec" kernels on one NVIDIA H100: bytes or the
instructions the SMs dispatch.

    python3 gelu_ablation.py           # GPT-2 124M's MLP epilogue, [2048, 3072] bf16

Builds ``csrc/bias_gelu.cu`` as it is and in variants (by editing a copy of
the source, so the variants follow the kernels; no wrapper of the package
ever loads them):

  kernel        the kernels as they are
  no_gelu       the GELU arithmetic taken out (gelu_tanh returns u,
                dgelu_tanh returns 1): the bytes alone
  exp_tanh      tanh through one exp and one reciprocal by the fast
                intrinsics (1 + tanh(z) = 2 / (1 + exp(-2z))): fewer
                instructions, results no longer the plain version's bits
  bwd_4_blocks  the backward's registers capped for 4 blocks an SM (and
                its bands sized for them) instead of 3

then times the forward and the whole backward
wrappers on the "vec" route on each, by CUDA-graph replay (one input set,
read from L2, and copies in turn, read cold), beside the bound by bytes. A variant's error against the plain version is printed beside its time
(no_gelu's only to show what it left out).

From ``cuobjdump -sass`` of each build it counts the machine instructions
of the bf16 "vec" kernels (bias in bf16, as the smp.nn path calls them), a
static count, divided by the elements a thread handles in one pass of its
loop (an upper estimate of the instructions an element: the count also
holds the prologue and the band's sum), and converts that to the time the
card's 132 SMs need to dispatch them (4 warp instructions a clock each, at the card's maximum SM
clock from ``nvidia-smi``).

Needs a card and ``nvcc``; exits non-zero without them. Prints the card's
name and power limit first.
"""

import ctypes
import os
import re
import subprocess
import sys
import tempfile
import time

import torch

_GELU = "  return __fmul_rn(__fmul_rn(0.5f, u), __fadd_rn(1.f, tanhf(inner_of(u))));\n"
_DGELU_HEAD = "__device__ __forceinline__ float dgelu_tanh(float u) {\n"
_DGELU_T = "  const float t = tanhf(inner_of(u));\n"
_BWD_BLOCKS = "constexpr int BWD_BLOCKS_PER_SM = 3;"
# tanh(z) = 2 / (1 + exp(-2z)) - 1 by the fast intrinsics: one ex2, one rcp.
_FAST_T = "__fadd_rn(__fdividef(2.f, __fadd_rn(1.f, __expf(-2.f * inner_of(u)))), -1.f)"

VARIANTS = {
    "kernel": [],
    "no_gelu": None,  # _source's own edit
    "exp_tanh": [("__fadd_rn(1.f, tanhf(inner_of(u)))", "__fdividef(2.f, __fadd_rn(1.f, __expf(-2.f * inner_of(u))))"),
                 (_DGELU_T, f"  const float t = {_FAST_T};\n")],
    "bwd_4_blocks": [(_BWD_BLOCKS, "constexpr int BWD_BLOCKS_PER_SM = 4;")],
}
N, F = 2048, 3072
SMS, WARP_INSTS = 132, 4  # H100 SXM: SMs, warp instructions an SM dispatches a clock


def _source(name, src):
    edits = VARIANTS[name]
    for old, _ in edits or [(_GELU, None), (_DGELU_HEAD, None)]:
        if old not in src:
            raise RuntimeError(f"variant {name}: the kernel no longer holds {old.strip()!r}")
    if edits is not None:
        for old, new in edits:
            src = src.replace(old, new)
        return src
    src = src.replace(_GELU, "  return u;\n")
    head = src.index(_DGELU_HEAD) + len(_DGELU_HEAD)
    return src[:head] + "  return 1.f;\n" + src[src.index("\n}\n", head) + 1:]


def _build(workdir):
    """Compile every variant (one nvcc each, started together); return
    {name: (path of its shared library, ptxas output)}."""
    from smdistributed_modelparallel_tpu_torch.ops import _build as build

    src = (build.CSRC / "bias_gelu.cu").read_text()
    procs = {}
    for name in VARIANTS:
        cu = os.path.join(workdir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(_source(name, src))
        so = os.path.join(workdir, f"{name}.so")
        procs[name] = (so, subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", so, cu],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        libs[name] = (so, log)
    return libs


def _use(bg, so):
    """Point ops.bias_gelu at the library ``so`` (same C interface)."""
    lib = ctypes.CDLL(so)
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    lib.smp_bias_gelu.argtypes = [c_int, c_int] + [c_ptr] * 4 + [c_int, c_int, c_ptr]
    lib.smp_bias_gelu.restype = c_int
    lib.smp_bias_gelu_vec.argtypes = [c_int] * 3 + [c_ptr] * 6 + [c_int] * 4 + [c_ptr]
    lib.smp_bias_gelu_vec.restype = c_int
    lib.smp_cuda_error_string.argtypes = [c_int]
    lib.smp_cuda_error_string.restype = ctypes.c_char_p
    bg._LIB = lib


def _sass_counts(so):
    """{kernel: static machine instructions} of the "vec" kernels with x and
    b in bf16 (mangled ``...vec_kernelI13__nv_bfloat16S..``) and the db sum."""
    from smdistributed_modelparallel_tpu_torch.ops import _build as build

    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True, check=True).stdout
    out = {}
    for section in sass.split("Function : ")[1:]:
        head = section.splitlines()[0]
        n = len(re.findall(r"/\*[0-9a-f]{4}\*/", section))
        for kernel in ("bias_gelu_fwd_vec_kernel", "bias_gelu_bwd_vec_kernel"):
            if f"{kernel}I13__nv_bfloat16S" in head:
                out[kernel] = n
        if "bias_gelu_db_kernelI13__nv_bfloat16" in head:
            out["bias_gelu_db_kernel"] = n
    return out


def main():
    if not torch.cuda.is_available():
        print("gelu_ablation: CUDA is not available; this runs on an H100.", file=sys.stderr)
        return 2
    from chip_smoke import GELU_COPIES, GELU_TOL, PEAK_BYTES_PER_S, copies_of, cuda_graph_time_ms, gelu_inputs, rotating

    from smdistributed_modelparallel_tpu_torch.ops import bias_gelu as bg

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    clock_mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                                     capture_output=True, text=True, check=True).stdout.split()[0])
    print(f"[card] {smi}; max SM clock {clock_mhz:.0f} MHz; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    x, b, g = gelu_inputs(N, F, torch.bfloat16, torch.Generator(device="cuda").manual_seed(1234), {})
    if bg._route(x.dtype, F, x.data_ptr(), g.data_ptr()) != "vec":
        raise RuntimeError("the path's shape does not take the vec route")
    sets = copies_of((x, b, g), GELU_COPIES)  # timed in turn: inputs cold, as chip_smoke's phase C
    want = {"bias_gelu_fwd": (bg.reference_bias_gelu(x, b),), "bias_gelu_bwd": bg.reference_bias_gelu_grads(x, b, g)}
    esz = x.element_size()
    nbytes = {"bias_gelu_fwd": 2 * N * F * esz + F * esz, "bias_gelu_bwd": 3 * N * F * esz + 2 * F * esz}
    from smdistributed_modelparallel_tpu_torch.ops import _build as build

    vu = int(re.search(r"constexpr int VU = (\d+);", (build.CSRC / "bias_gelu.cu").read_text()).group(1))
    per_thread = vu * 16 // esz  # elements a thread handles in one pass of its loop
    inst_rate = SMS * WARP_INSTS * 32 * clock_mhz * 1e6  # thread instructions a second
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        libs = _build(workdir)
        print(f"[build] {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
        for name, (so, log) in libs.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[build] {name}: {line.strip()}", flush=True)
            for kernel, n in _sass_counts(so).items():
                extra = ""
                if kernel != "bias_gelu_db_kernel":
                    per_elem = n / per_thread
                    extra = (f", {per_elem:.1f} a element ({per_thread} elements a thread and pass); dispatching them "
                             f"for [{N}, {F}] takes {per_elem * N * F / inst_rate * 1e3:.4f} ms")
                print(f"[sass] {name:8s} {kernel}<bf16, bf16>: {n} instructions (static){extra}", flush=True)
            _use(bg, so)
            bg._BWD_BLOCKS_PER_SM = 4 if name == "bwd_4_blocks" else 3  # the bands follow the residency
            for wrapper, fn in (("bias_gelu_fwd", lambda x_, b_, g_: bg.bias_gelu_fwd(x_, b_)),
                                ("bias_gelu_bwd", bg.bias_gelu_bwd)):
                ms = cuda_graph_time_ms(lambda: fn(x, b, g))
                cold_ms = cuda_graph_time_ms(rotating(fn, sets))
                got = fn(x, b, g)
                got = got if isinstance(got, tuple) else (got,)
                err = max(float((a.float() - w.float()).abs().max()) for a, w in zip(got, want[wrapper]))
                atol, rtol = GELU_TOL[x.dtype]  # y, dx (the first output) against phase B's tolerance
                share = float(((got[0].float() - want[wrapper][0].float()).abs()
                               / (atol + rtol * want[wrapper][0].float().abs())).max())
                bound = nbytes[wrapper] / PEAK_BYTES_PER_S * 1e3
                print(f"[ablation] {wrapper} N={N} F={F} bf16 {name:8s} by graph replay, inputs in L2 {ms:.4f} ms, "
                      f"cold {cold_ms:.4f} ms ({nbytes[wrapper] / cold_ms / 1e6:.1f} GB/s; bound by bytes "
                      f"{bound:.4f} ms, {bound / cold_ms:.1%} of it); max|d| {err:.2e} off the plain version, "
                      f"{'y' if wrapper == 'bias_gelu_fwd' else 'dx'} at {share:.2f} of GELU_TOL",
                      flush=True)
    bg._LIB = None
    bg._BWD_BLOCKS_PER_SM = 3
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
