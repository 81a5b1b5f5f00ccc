#!/usr/bin/env python3
"""How fast a row kernel can stream its state and timer rows, by load pattern.

    python3 scripts/row_stream_probe.py

Builds ``scripts/row_stream_probe.cu`` (the flags of ``ops/_cuda.py``) and
times each of its load patterns with CUDA events on the inputs of
``chip_smoke.kernel_inputs`` at the shapes the main path launches K3 and
K4 at (N = 16,384 int16 and N = 8,192 int32, about 80 % of rows alive):
the kernels do nothing but load each alive row's state and timer words
once, so each time is the floor a row kernel with that pattern can reach.
Prints the card line, then one JSON line per shape with each pattern's
time (two turns, forward then back) and the bytes bound. Needs a CUDA card
and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
PATTERNS = ("ring_w4_s4", "ring_w4_s2", "ahead_d1", "ahead_d2", "ahead_d4", "block")


def main() -> int:
    import torch

    from chip_smoke import HBM_BYTES_PER_S, card_line, kernel_inputs, time_ms
    from kaboodle_tpu_torch.ops import _cuda

    if not torch.cuda.is_available():
        print("row_stream_probe: no CUDA device is available", file=sys.stderr)
        return 2
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = _cuda.BUILD_DIR / "librow_stream_probe.so"
    src = ROOT / "scripts" / "row_stream_probe.cu"
    subprocess.run([_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.kb_row_stream.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_void_p]
    lib.kb_row_stream.restype = ctypes.c_int
    print(card_line(), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for n, dt in ((16384, torch.int16), (8192, torch.int32)):
        state, timer, alive, _ = kernel_inputs(n, dt, gen)
        out = torch.empty((n, 32), dtype=torch.int32, device="cuda")
        live = int(alive.sum())
        times = {p: [] for p in PATTERNS}
        for p in PATTERNS + PATTERNS[::-1]:
            def run(i=PATTERNS.index(p)):
                rc = lib.kb_row_stream(i, state.data_ptr(), timer.data_ptr(), timer.element_size(),
                                       alive.data_ptr(), out.data_ptr(), n,
                                       _cuda.stream_handle(state.device))
                if rc:
                    raise RuntimeError(f"launch failed: CUDA error {rc}")
            times[p].append(time_ms(run, 20))
        nbytes = live * n * (1 + timer.element_size())
        print(json.dumps({"n": n, "timer": str(dt).replace("torch.", ""), "rows_alive": live,
                          "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "ms": times}),
              flush=True)
        del state, timer, alive, out
    return 0


if __name__ == "__main__":
    sys.exit(main())
