#!/usr/bin/env python3
"""Host cost of one kernel wrapper call of the PyTorch port, piece by piece.

Run from the root of a checkout on a machine with a CUDA card:

    python3 scripts/torch_host_cost.py

It calls ``repro_torch.kernels.rmsnorm.rmsnorm`` at decode's shape (4 rows
of granite-3-2b's d 2048, bf16) under ``torch.no_grad()``, where the
device work is a few microseconds and the host sets the pace, and times
with ``time.perf_counter`` over many calls: the whole wrapper, then each
step of its path alone (the input checks, the grad-mode gate, the output
allocation, the stream lookup, the pointers, the ctypes call into the
library, which makes the device current and launches), beside two
yardsticks: the stream lookup through ``torch.cuda.current_stream``, and a
ctypes call of a C function that does nothing on the card.  One line per
step, in microseconds per call, and the card's name and power limit.  It
exits non-zero without a card.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CALLS = 5000


def per_call_us(fn, calls: int = CALLS) -> float:
    import torch

    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_host_cost: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import rmsnorm as mod
    from repro_torch.kernels.autograd import kernel_call
    from repro_torch.kernels.build import DTYPE_CODES, stream_of

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    x = torch.randn(4, 2048, device=dev).to(torch.bfloat16)
    sc = torch.randn(2048, device=dev).to(torch.bfloat16)
    out = torch.empty_like(x)
    mod.KERNEL.load()
    args = (x.data_ptr(), sc.data_ptr(), out.data_ptr(), 4, 2048, 1e-5, 1,
            DTYPE_CODES[x.dtype], 0, stream_of(x))
    steps = {
        "whole wrapper, rmsnorm(x, scale)": lambda: mod.rmsnorm(x, sc),
        "_check(x, scale)": lambda: mod._check(x, sc),
        "torch.empty_like(x)": lambda: torch.empty_like(x),
        "kernel_call gate around a launch that does nothing":
            lambda: kernel_call(lambda *a: None, None, x, sc, 1e-5),
        "stream_of(x)": lambda: stream_of(x),
        "torch.cuda.current_stream(x.device).cuda_stream":
            lambda: torch.cuda.current_stream(x.device).cuda_stream,
        "x.device.index": lambda: x.device.index,
        "three data_ptr() calls": lambda: (x.data_ptr(), sc.data_ptr(), out.data_ptr()),
        "KERNEL.launch(...) with its arguments ready": lambda: mod.KERNEL.launch(*args),
        "ctypes call of repro_error_string(0)": lambda: mod.KERNEL._error_string(0),
    }
    with torch.no_grad():
        for name, fn in steps.items():
            print(f"[host] {name}: {per_call_us(fn):.3f} us per call")
    print(f"[host] x (4,2048) bf16, {CALLS} calls per step | nvidia-smi: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
