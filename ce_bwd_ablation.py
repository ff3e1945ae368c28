#!/usr/bin/env python3
"""Where the fused-CE backward's tensor-core kernels spend their time, on one
NVIDIA H100.

    python3 ce_bwd_ablation.py           # GPT-2 124M's head at N = 32768

Builds ``csrc/fused_ce.cu`` as it is and in variants that each take one part
out of ``fused_ce_bwd_wgmma_kernel`` (by editing a copy of the source, so the
variants follow the kernel), then times the dx and dW wrappers on each, by
CUDA events, at D 768 (clusters of 3 CTAs) and D 256 (one CTA). A variant
that takes a part out computes a wrong result; its error against the plain
version is printed beside its time only to show what it left out.

  kernel           the kernel as it is
  no_helper_sum    the helper warps do not add the cluster's partials
  no_lo            dlog enters the contraction as one bf16 value (no lo part)
  barriers_only    no products, no dlog and no sums: the tile loop's
                   synchronization (cluster barrier, mbarriers, exchange
                   buffers) alone

Needs a card and ``nvcc``; exits non-zero without them. Prints the card's
name and power limit first.
"""

import ctypes
import os
import subprocess
import sys
import tempfile
import time

import torch

_HELPER_SUM = "        tc::sum_partials(S, xch, zsum, h);\n"
_Z = ("          wgmma_n64_ss<bf16>(z, desc_sw128(a_own + b * tc::OWN_BOX + 32 * kk),\n"
      "                             desc_sw128(st + b * tc::WALK_BOX + 32 * kk), (b | kk) != 0);")
_HI = "          wgmma_n64_rs<bf16>(acc[b], hf + 4 * kk, desc_sw128_mn(st + b * tc::WALK_BOX + 2048 * kk));"
_LO = "          wgmma_n64_rs<bf16>(acc[b], lf + 4 * kk, desc_sw128_mn(st + b * tc::WALK_BOX + 2048 * kk));"
_DLOG = "          if (orow[hh] < owned_total && (inner || (DW ? tok < p.N : voc < p.V))) {"

VARIANTS = {
    "kernel": [],
    "no_helper_sum": [(_HELPER_SUM, "")],
    "no_lo": [(_LO, "          ;")],
    "barriers_only": [(_HELPER_SUM, ""), (_Z, "          ;"), (_HI, "          ;"), (_LO, "          ;"),
                      (_DLOG, "          d = z[4 * j + 2 * hh + e]; if (false) {")],
}
SHAPES = ((32768, 768), (32768, 256))  # (N, D) at V 50257


def _build(workdir):
    """Compile every variant (one nvcc each, started together); return
    {name: path of its shared library}."""
    from smdistributed_modelparallel_tpu_torch.ops import _build as build

    src = (build.CSRC / "fused_ce.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: the kernel no longer holds {old.strip()!r}")
            text = text.replace(old, new)
        cu = os.path.join(workdir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(workdir, f"{name}.so")
        procs[name] = (so, subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", so, cu],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        libs[name] = so
    return libs


def _use(fc, so):
    """Point ops.fused_ce at the library ``so`` (same C interface)."""
    lib = ctypes.CDLL(so)
    c_int, c_float, c_ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    for entry in (lib.smp_fused_ce_bwd, lib.smp_fused_ce_bwd_wgmma):
        entry.argtypes = [c_int, c_int] + [c_ptr] * 5 + [c_int] * 4 + [c_float, c_float, c_int] + [c_ptr] * 3
        entry.restype = c_int
    lib.smp_fused_ce_fwd.argtypes = [c_int] + [c_ptr] * 3 + [c_int] * 5 + [c_ptr] * 5
    lib.smp_fused_ce_fwd.restype = c_int
    lib.smp_fused_ce_bwd_wgmma_clusters.argtypes = [c_int, c_int]
    lib.smp_fused_ce_bwd_wgmma_clusters.restype = c_int
    lib.smp_cuda_error_string.argtypes = [c_int]
    lib.smp_cuda_error_string.restype = ctypes.c_char_p
    fc._LIB = lib
    fc._MAX_CLUSTERS.clear()


def main():
    if not torch.cuda.is_available():
        print("ce_bwd_ablation: CUDA is not available; this runs on an H100.", file=sys.stderr)
        return 2
    from chip_smoke import ce_inputs, cuda_time_ms

    from smdistributed_modelparallel_tpu_torch.ops import fused_ce as fc

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[card] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        libs = _build(workdir)
        print(f"[build] {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
        gen = torch.Generator(device="cuda").manual_seed(1234)
        V = 50257
        for N, D in SHAPES:
            x, w, t, _ = ce_inputs(N, V, D, torch.bfloat16, gen, {})
            g = torch.full((N,), 1.0 / N, device="cuda")
            lse = fc.fused_ce_fwd_reference(x, w, t)[0]
            want = {"dx": fc.fused_ce_bwd_dx_reference(x, w, t, lse, g),
                    "dw": fc.fused_ce_bwd_dw_reference(x, w, t, lse, g)}
            for name, so in libs.items():
                _use(fc, so)
                for out, fn in (("dx", fc.fused_ce_bwd_dx), ("dw", fc.fused_ce_bwd_dw)):
                    ms = cuda_time_ms(lambda: fn(x, w, t, lse, g), 3, 1)
                    got = fn(x, w, t, lse, g)
                    err = float((got.float() - want[out].float()).abs().max() / want[out].float().abs().max())
                    print(f"[ablation] N={N} V={V} D={D} {out} {name:14s} {ms:.3f} ms "
                          f"({2 * 2 * N * V * D / ms / 1e9:.1f} TFLOP/s of the function's); "
                          f"{err:.2e} of max|grad| off the plain version", flush=True)
            del x, w, t, g, lse, want
            torch.cuda.empty_cache()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
