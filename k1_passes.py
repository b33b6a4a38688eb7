#!/usr/bin/env python3
# SPDX-License-Identifier: CECILL-2.1
"""Device time of kernel K1 by pass, at the layouts whose pass 1 runs above
2048 rows, at Config D's 2048^2 layouts and at sides with an odd factor, on
one NVIDIA GPU.

    python3 k1_passes.py [--root DIR] [--label NAME]
    python3 k1_passes.py --variants

Imports ``barc4dip_tpu_torch`` from DIR (default: this checkout), so two
trees can be timed in one process each on the same card (run them in
turns: parent, change, change, parent). Each layout takes random complex64
spectra made on the card (the kernel's time does not depend on the
values), calls the wrapper once, then 10 times under torch.profiler, and
prints one JSON line: the device time per call of pass 1 (the column
kernels) and pass 2 (the row kernels), pass 1's effective rate (the
spectra read once plus the mid plane written once, over its time), the
device time of cuFFT's ``irfft2`` of the products formed beforehand (the
library call), and the card's name and power limit as nvidia-smi gives
them. Exits non-zero without a card.

``--variants`` times pass 1's cluster route (``corr_cols_cluster``) at
other plans than the one the source dispatches: for each side in
VARIANT_SIDES and each (Q blocks a cluster, CC columns a cluster) in its
list, a copy of ``csrc/fftp_corr.cu`` with one C entry that launches that
instantiation is built under ``build/k1_variants/`` (one ``nvcc`` a
variant, all started together), held against ``torch.fft.ifft`` down the
columns of each image's spectrum times its own conjugate (within 2e-5 of
the max) and timed by CUDA events (median of 5 runs
of 20 launches, variants in turns), one JSON line a variant.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

REPEATS = 10
# (kernel, H, W, images, templates): K1a as autocorr2d / a chunk's grain
# sends it (F against itself), K1b as the tracker does (9 templates, a bank
# shared by the images)
LAYOUTS = [
    ("K1a", 8192, 8192, 1, 1),
    ("K1a", 3072, 3072, 4, 1),
    ("K1a", 2560, 2048, 1, 1),
    ("K1a", 4096, 4096, 4, 1),
    ("K1b", 4096, 4096, 4, 9),
    ("K1a", 2048, 2048, 4, 1),
    ("K1b", 2048, 2048, 4, 9),
    # sides with an odd factor m: 3 (1536), 5 (2560 columns), 63 (8064), 9
    # (2304 rows, a qCMOS sensor's frame)
    ("K1a", 1536, 1536, 1, 1),
    ("K1b", 2048, 2560, 1, 9),
    ("K1a", 8064, 8064, 1, 1),
    ("K1a", 2304, 4096, 4, 1),
]


# (H, W, planes): {(Q, CC), ...} for --variants
VARIANT_SIDES = {
    (8192, 8192, 1): [(8, 16), (16, 16), (16, 8), (16, 4)],
    (4096, 4096, 4): [(8, 16), (8, 8), (16, 16), (16, 8), (16, 4)],
    (3072, 3072, 4): [(8, 16), (8, 8), (16, 16), (16, 8), (16, 4)],
    (6144, 2048, 2): [(8, 16), (8, 8), (16, 16), (16, 8)],
    (2560, 2048, 1): [(8, 16), (8, 8), (16, 16), (16, 8)],
    (5120, 2048, 2): [(8, 8), (16, 16), (16, 8)],
    (7680, 2048, 1): [(8, 8), (16, 16), (16, 8)],
    (4224, 2048, 2): [(8, 16), (8, 8), (8, 4)],
    (8064, 2048, 1): [(8, 16), (8, 8), (8, 4)],
    (2176, 2048, 2): [(8, 16), (8, 8), (8, 4)],
}
_VARIANT_ENTRY = """
extern "C" {
const char* fftp_corr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
int variant_cols(int device, const void* F, const void* G, void* mid, const void* tw, int m, int W,
                 int NB, int K, void* stream) {
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_cluster<VAR_LOGL, VAR_M, VAR_Q, VAR_CC>(
      device, static_cast<const float2*>(F), static_cast<const float2*>(G), static_cast<float2*>(mid),
      static_cast<const float2*>(tw), m, W, NB, K, 0, static_cast<cudaStream_t>(stream));
}
}
"""


def build_variants(nvcc_mod) -> dict:
    """Compile every variant of VARIANT_SIDES; {(H, Q, CC): library path}."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from barc4dip_tpu_torch.ops.cuda_fftp import odd_radices

    src = (nvcc_mod.CSRC / "fftp_corr.cu").read_text()
    src = src[: src.index('extern "C" {')] + _VARIANT_ENTRY
    out_dir = nvcc_mod.BUILD_DIR.parent / "k1_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for (H, _W, _nb), plans in VARIANT_SIDES.items():
        for Q, CC in plans:
            L = H // Q
            loga = (L & -L).bit_length() - 1
            m = L >> loga
            stem = f"v{H}_{Q}_{CC}"
            cu = out_dir / f"{stem}.cu"
            cu.write_text(src)
            # M as the source's route_of(m) gives it: m, or 0 on the direct route
            defs = [f"-DVAR_LOGL={loga}", f"-DVAR_M={m if odd_radices(m) is not None else 0}",
                    f"-DVAR_Q={Q}", f"-DVAR_CC={CC}"]
            cmd = [nvcc_mod._nvcc(), *nvcc_mod.NVCC_FLAGS, f"-I{nvcc_mod.CSRC}", *defs,
                   "-o", str(out_dir / f"lib{stem}.so"), str(cu)]
            jobs[(H, Q, CC)] = cmd
    with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        procs = {key: pool.submit(subprocess.run, cmd, capture_output=True, text=True)
                 for key, cmd in jobs.items()}
    libs = {}
    for key, fut in procs.items():
        proc = fut.result()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {key} did not build:\n{proc.stderr[-3000:]}")
        regs = [ln.split(":", 1)[-1].strip() for ln in (proc.stdout + proc.stderr).splitlines()
                if "registers" in ln or "spill" in ln]
        print(json.dumps({"variant": list(key), "ptxas": regs}), flush=True)
        libs[key] = jobs[key][-2]
    return libs


def run_variants(torch, card: str) -> None:
    import ctypes

    import numpy as np

    from barc4dip_tpu_torch.ops import _nvcc, cuda_fftp

    libs = build_variants(_nvcc)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    p, i = ctypes.c_void_p, ctypes.c_int
    for (H, W, nb), plans in VARIANT_SIDES.items():
        wh, wq = W // 2 + 1, W // 2
        F = torch.complex(torch.randn((nb, H, wh), generator=g, device=dev),
                          torch.randn((nb, H, wh), generator=g, device=dev))
        want = torch.fft.ifft((F * F.conj())[..., 1:wq], dim=-2) * H
        scale = float(want.abs().max())
        mid = torch.empty((nb, H, wq), dtype=torch.complex64, device=dev)
        runs = {}
        for Q, CC in plans:
            lib = ctypes.CDLL(libs[(H, Q, CC)])
            fn = lib.variant_cols
            fn.argtypes = [i, p, p, p, p, i, i, i, i, p]
            fn.restype = i
            L = H // Q
            table = np.concatenate([cuda_fftp.stage_twiddles(L), np.exp(2j * np.pi * np.arange(H) / H)])
            tw = torch.from_numpy(table.astype(np.complex64)).to(dev)
            m = L >> ((L & -L).bit_length() - 1)
            call = (lambda fn=fn, tw=tw, m=m: fn(0, F.data_ptr(), F.data_ptr(), mid.data_ptr(),
                                                  tw.data_ptr(), m, W, nb, 1, stream))
            rc = call()
            torch.cuda.synchronize()
            if rc != 0:
                raise RuntimeError(f"variant {(H, Q, CC)}: launch failed, CUDA error {rc}")
            err = float((mid[..., 1:wq] - want).abs().max())
            if not err <= 2e-5 * scale:
                raise AssertionError(f"variant {(H, Q, CC)}: max err {err:.3e} > 2e-5 * {scale:.3e}")
            runs[(Q, CC)] = (call, tw, err)
        times = {key: [] for key in runs}
        for rep in range(5):
            for key in (list(runs) if rep % 2 == 0 else list(runs)[::-1]):
                call = runs[key][0]
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(20):
                    call()
                end.record()
                end.synchronize()
                times[key].append(start.elapsed_time(end) / 20)
        moved = F.numel() * 8 + mid.numel() * 8
        for (Q, CC), ts in times.items():
            ms = float(np.median(ts))
            print(json.dumps({"variant": [H, Q, CC], "shape": [H, W], "planes": nb,
                              "threads": CC * H // Q // 16, "pass1_ms": ms,
                              "pass1_tb_s": moved / (ms * 1e-3) / 1e12, "max_abs_err": runs[(Q, CC)][2],
                              "card": card}), flush=True)
        del F, want, mid, runs
        torch.cuda.empty_cache()


def device_ms(torch, fn) -> dict:
    """Device time per call (ms) by kernel name over REPEATS calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(REPEATS):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation or not e.self_device_time_total:
            continue
        name = re.sub(r"^void |\(anonymous namespace\)::", "", e.key).split("(")[0][:60]
        out[name] = out.get(name, 0.0) + e.self_device_time_total / REPEATS / 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent),
                    help="tree to import barc4dip_tpu_torch from")
    ap.add_argument("--label", default=None, help="name printed with each line (default: the root)")
    ap.add_argument("--variants", action="store_true", help="time pass 1's cluster route at other plans")
    args = ap.parse_args()
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("k1_passes: no CUDA device", file=sys.stderr)
        return 1
    from barc4dip_tpu_torch.ops import cuda_fftp

    if not cuda_fftp.__file__.startswith(root):
        raise RuntimeError(f"imported {cuda_fftp.__file__}, not from {root}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    if args.variants:
        run_variants(torch, card)
        return 0
    cuda_fftp.build()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    for kind, H, W, nf, k in LAYOUTS:
        wh = W // 2 + 1

        def spectra(*shape):
            return torch.complex(torch.randn(shape, generator=g, device=dev),
                                 torch.randn(shape, generator=g, device=dev))

        F = spectra(nf, H, wh)
        if kind == "K1a":
            G = F[:, None]
            call = lambda: cuda_fftp.corr_from_rfft(F, G, s=(H, W))  # noqa: E731
            spectra_bytes = F.numel() * 8
        else:
            G = spectra(k, H, wh)
            var = torch.rand((nf, H, W), generator=g, device=dev) + 0.5
            en = torch.rand((k,), generator=g, device=dev) + 0.5
            call = lambda: cuda_fftp.ncc_masked_peaks(  # noqa: E731
                F, G, var, en, valid_hw=(H - 28, W - 28), eps=1e-9, s=(H, W))
            spectra_bytes = (F.numel() + G.numel()) * 8
        split = device_ms(torch, call)
        p1 = sum(v for n, v in split.items() if n.startswith("corr_cols"))
        p2 = sum(v for n, v in split.items() if n.startswith("corr_rows"))
        mid_bytes = nf * k * H * (W // 2) * 8
        prod = F[:, None] * (G if G.dim() == 4 else G[None]).conj()
        lib = sum(device_ms(torch, lambda: torch.fft.irfft2(prod, s=(H, W))).values())
        del prod
        print(json.dumps({
            "tree": args.label or root, "kernel": kind, "shape": [H, W], "planes": nf * k,
            "pass1_ms": p1, "pass2_ms": p2,
            "pass1_tb_s": (spectra_bytes + mid_bytes) / (p1 * 1e-3) / 1e12 if p1 > 0 else None,
            "library_device_ms": lib, "kernels": split, "card": card,
        }), flush=True)
        del F, G, call
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
