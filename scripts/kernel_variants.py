#!/usr/bin/env python3
"""The design choices of the SSD and WKV6 scan kernels, measured against
their alternatives on the card.

Run from the root of a checkout on a machine with a CUDA card:

    python3 scripts/kernel_variants.py

Each variant is the shipped source (``src/repro_torch/kernels/csrc/
mamba2_ssd.cu`` or ``wkv6.cu``) with one constant or one condition
replaced, written to ``build/variants/`` and built with the same ``nvcc``
flags as the port's kernels (one process per variant, all started
together).  Every variant is called through the entry's C interface on the
serving shapes with bf16 inputs (zamba2-2.7b: B 4, H 80, P 64, N 64, x, B
and C views of one (4, S, 5248) buffer; rwkv6-7b: B 4, H 64, hd 64) at S
512, 65 and 1, checked against the plain version at the tolerances of
``chip_smoke.py`` and timed as ``chip_smoke.py`` times its ``device`` ms
(CUDA events around the replay of a CUDA graph of 20 calls).  One line per
variant and S, each variant's ``ptxas`` registers, stack and spills for the
kernel it changes, and the card's name and power limit.  It exits non-zero
without a card or when a variant disagrees with the plain version.

The variants:

* ``ssd L32`` (shipped): the chunked kernel at 32-step chunks, its
  registers held to what 3 blocks an SM leave;
* ``ssd L64``: 64-step chunks, no register cap (3 blocks an SM would spill);
* ``wkv6 8 columns`` (shipped): the prefill kernel's thread tile at hd 64 is
  8 rows by 8 columns;
* ``wkv6 4 columns``: 8 rows by 4 columns (twice the threads);
* ``wkv6 tile at decode``: S 1 takes the prefill kernel in place of the
  one-thread-per-column kernel.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "variants"

SSD_L = "constexpr int kL = 32;  // time steps per chunk"
SSD_CAP = "kWide ? 1 : 3)"
WKV6_COLS = "static constexpr int kCols = HD >= 64 ? 8 : 4;"
WKV6_DECODE = "  if (S == 1)\n    wkv6_column_kernel"

#: name -> (source, [(shipped text, variant text)], the changed kernel's name)
VARIANTS = {
    "ssd L32": ("mamba2_ssd.cu", [], "ssd_chunked_kernel"),
    "ssd L64": ("mamba2_ssd.cu", [(SSD_L, SSD_L.replace("32", "64")),
                                  (SSD_CAP, "kWide ? 1 : 1)")], "ssd_chunked_kernel"),
    "wkv6 8 columns": ("wkv6.cu", [], "wkv6_tile_kernel"),
    "wkv6 4 columns": ("wkv6.cu", [(WKV6_COLS, "static constexpr int kCols = 4;")],
                       "wkv6_tile_kernel"),
    "wkv6 tile at decode": ("wkv6.cu", [(WKV6_DECODE, WKV6_DECODE.replace("S == 1", "false"))],
                            "wkv6_tile_kernel"),
}


def graph_ms(fn, reps: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build(names):
    """Write and compile every variant at once; returns {name: ctypes.CDLL}."""
    from repro_torch.kernels.build import NVCC_FLAGS, nvcc_path

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        source, edits, _ = VARIANTS[name]
        text = (CSRC / source).read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in {source} exactly once")
            text = text.replace(old, new)
        stem = name.replace(" ", "_")
        (OUT / f"{stem}.cu").write_text(text)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(OUT / f"{stem}.so"),
               str(OUT / f"{stem}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        kernel, current = VARIANTS[name][2], ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                current = line.split("'")[1]
            elif kernel in current and ("stack frame" in line or "Used" in line):
                print(f"[variant/{name}] ptxas {current[-40:]}: {line.strip()}")
        libs[name] = ctypes.CDLL(str(OUT / f"{name.replace(' ', '_')}.so"))
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.build import DTYPE_CODES, stream_of
    from repro_torch.kernels.mamba2_ssd import KERNEL as SSD
    from repro_torch.kernels.wkv6 import KERNEL as WKV6

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    libs = build(list(VARIANTS))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def randn(*shape, mul=1.0, add=0.0):
        return torch.randn(shape, generator=gen, device=dev) * mul + add

    def ssd_case(lib, S):
        buf = randn(4, S, 5248, mul=0.5).to(bf16)
        x, bm, cm = buf[..., :5120].reshape(4, S, 80, 64), buf[..., 5120:5184], buf[..., 5184:]
        dt = F.softplus(randn(4, S, 80))
        args = (x, bm, cm, torch.exp(-dt), dt, randn(4, 80, 64, 64))
        y, sT = torch.empty(4, S, 80, 64, device=dev), torch.empty(4, 80, 64, 64, device=dev)
        fn = lib.repro_mamba2_ssd
        fn.argtypes, fn.restype = SSD.argtypes, ctypes.c_int

        def call():
            code = fn(*(a.data_ptr() for a in args), y.data_ptr(), sT.data_ptr(), 4, 80, S, 64,
                      64, x.stride(0), x.stride(1), bm.stride(0), bm.stride(1), cm.stride(0),
                      cm.stride(1), DTYPE_CODES[bf16], 0, stream_of(x))
            if code:
                raise RuntimeError(f"launch failed: CUDA error {code}")

        call()
        y_ref, s_ref = ref.mamba2_ssd_scan(*args)
        ok = (torch.allclose(y, y_ref, rtol=1e-4, atol=1e-4)
              and torch.allclose(sT, s_ref, rtol=1e-4, atol=1e-4))
        return ok, call

    def wkv6_case(lib, S):
        r, k = randn(4, 64, S, 64, mul=0.5).to(bf16), randn(4, 64, S, 64, mul=0.5).to(bf16)
        v = randn(4, 64, S, 64).to(bf16)
        w = torch.exp(-torch.exp(randn(64, 64, mul=0.1, add=-6.0)[None, :, None]
                                 + randn(4, 64, S, 64, mul=0.5))).to(bf16)
        args = (r, k, v, w, randn(64, 64, mul=0.1), randn(4, 64, 64, 64))
        y, sT = torch.empty_like(r), torch.empty(4, 64, 64, 64, device=dev)
        fn = lib.repro_wkv6
        fn.argtypes, fn.restype = WKV6.argtypes, ctypes.c_int

        def call():
            code = fn(*(a.data_ptr() for a in args), y.data_ptr(), sT.data_ptr(), 4 * 64, 64, S,
                      64, DTYPE_CODES[bf16], 0, stream_of(r))
            if code:
                raise RuntimeError(f"launch failed: CUDA error {code}")

        call()
        y_ref, s_ref = ref.rwkv6_scan(*args)
        ok = (torch.allclose(y.float(), y_ref.float(), rtol=2e-2, atol=2e-2)
              and torch.allclose(sT, s_ref, rtol=1e-3, atol=1e-4))
        return ok, call

    all_ok = True
    for name, lib in libs.items():
        case = ssd_case if name.startswith("ssd") else wkv6_case
        for S in (512, 65, 1):
            ok, call = case(lib, S)
            all_ok &= ok
            print(f"[variant/{name}] S={S} device {graph_ms(call):.4f} ms "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
    print(card)
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
