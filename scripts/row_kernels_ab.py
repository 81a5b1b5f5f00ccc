#!/usr/bin/env python3
"""K1-K3 builds side by side: this tree's ``fused_suspicion.cu`` and ``fused_fp.cu`` against another checkout's, or against probes.

    python3 scripts/row_kernels_ab.py [--other DIR] [--probes] [--rounds R]

``--other DIR`` adds the two sources of another checkout's root (with that
checkout's ``common.cuh``), for example the parent commit unpacked with
``git archive``. ``--probes`` adds builds of this tree's sources with one
edit each (the table ``PROBES``: rows a block, chunks loaded ahead, rows a
band), each computing the same function.
The entry points take the row count and row offset of a row slice
(``n_rows, row0, n``), so ``--other`` needs a checkout that has them.

Every build is compiled with the flags of ``ops/_cuda.py`` (one nvcc each,
all at once) into ``_build/`` under its own name and loaded with ctypes
through the same C entry point as the wrappers. At the six shapes the main
path launches K1-K3 at (``SHAPES``; inputs of ``chip_smoke.kernel_inputs``,
thr = 9 as in ``chip_smoke.measure``) every build of the kernel is first
checked bit-exact against the plain version (so all builds give the same
bits), then timed with CUDA events (``chip_smoke.time_ms``) for ``--rounds``
rounds, the builds in order and then back in alternate rounds, each round
ending with this tree's launch floor (its empty kernel at the same grid and
block, ``launch_floor``). Prints the card line, then one JSON line per shape
with each build's times, their medians and each build's median over the
other checkout's ("ratio"). Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
CSRC = Path("kaboodle_tpu_torch/csrc")
SOURCES = ("fused_suspicion", "fused_fp")
# (kernel, n, timer dtype, the run that launches it, launches per call)
SHAPES = (
    ("fused_suspicion", 1024, "int32", "warp_drain", 200),
    ("fused_suspicion", 16384, "int16", "boot", 20),
    ("fused_suspicion", 8192, "int32", "churn", 20),
    ("fused_fp_idv", 1024, "int32", "warp_drain", 200),
    ("fused_fp_idv", 8192, "int32", "churn", 20),
    ("fused_fp_hash", 16384, "int16", "boot", 20),
)
def _set(name: str, old: int, new: int) -> tuple[str, str]:
    return f"constexpr int {name} = {old};", f"constexpr int {name} = {new};"


# name: (source, edits as (old, new) pairs)
PROBES = {
    "sus_rows4": ("fused_suspicion", [_set("kRows", 8, 4)]),
    "sus_rows16": ("fused_suspicion", [_set("kRows", 8, 16)]),
    "sus_short_depth1": ("fused_suspicion", [_set("kDepthShort", 2, 1)]),
    "sus_long_depth2": ("fused_suspicion", [_set("kDepthLong", 4, 2)]),
    "fp_warps2": ("fused_fp", [_set("kWarps", 4, 2)]),
    "fp_warps8": ("fused_fp", [_set("kWarps", 4, 8)]),
    "fp_band2": ("fused_fp", [_set("kBand", 4, 2)]),
    "fp_band8": ("fused_fp", [_set("kBand", 4, 8)]),
}


def probe_sources(out_dir: Path) -> dict[str, tuple[str, Path]]:
    """Write each probe's source beside a copy of this tree's ``common.cuh``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "common.cuh").write_text((ROOT / CSRC / "common.cuh").read_text())
    paths = {}
    for name, (source, edits) in PROBES.items():
        text = (ROOT / CSRC / f"{source}.cu").read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"probe {name}: the source no longer has the text it edits")
            text = text.replace(old, new)
        paths[name] = (source, out_dir / f"{name}.cu")
        paths[name][1].write_text(text)
    return paths


def build(builds: dict[str, tuple[str, Path]]) -> dict[str, ctypes.CDLL]:
    """Compile every build at once; ``builds`` maps a name to (source, .cu path)."""
    from kaboodle_tpu_torch.ops import _cuda
    from kaboodle_tpu_torch.ops.fused_fp import _ARGTYPES as FP_ARGS
    from kaboodle_tpu_torch.ops.fused_suspicion import _ARGTYPES as SUS_ARGS

    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (_, src) in builds.items():
        out = _cuda.BUILD_DIR / f"librow_ab_{name}.so"
        cmd = [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-I", str(src.parent), "-o", str(out),
               str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {builds[name][1]}:\n{log}")
        lib = ctypes.CDLL(str(out))
        fn = lib.kb_fused_suspicion if builds[name][0] == "fused_suspicion" else lib.kb_fused_fp
        fn.argtypes = SUS_ARGS if builds[name][0] == "fused_suspicion" else FP_ARGS
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launcher(kernel: str, n: int, dtype: str, gen):
    """(run(lib), outputs, the plain version's outputs) on one set of inputs."""
    import torch

    from chip_smoke import kernel_inputs
    from kaboodle_tpu_torch.ops import _cuda
    from kaboodle_tpu_torch.ops.fused_fp import fused_fp_count_plain
    from kaboodle_tpu_torch.ops.fused_suspicion import fused_suspicion_plain
    from kaboodle_tpu_torch.ops.hashing import peer_record_hash

    state, timer, alive, idv = kernel_inputs(n, getattr(torch, dtype), gen)
    stream = _cuda.stream_handle(state.device)
    if kernel == "fused_suspicion":
        thr = 9
        want = fused_suspicion_plain(state, timer, alive, thr)
        outs = [torch.empty_like(w) for w in want]
        vec = _cuda.vec_ok(n, state, timer)

        def run(lib):
            return lib.kb_fused_suspicion(
                state.data_ptr(), timer.data_ptr(), timer.element_size(), alive.data_ptr(), thr,
                *(o.data_ptr() for o in outs), n, 0, n, vec, stream)
    else:
        ident = idv if kernel == "fused_fp_idv" else peer_record_hash(
            torch.arange(n, device="cuda"), idv[0])
        want = fused_fp_count_plain(state, ident)
        outs = [torch.empty_like(w) for w in want]
        vec = _cuda.vec_ok(n, state, ident)

        def run(lib):
            return lib.kb_fused_fp(state.data_ptr(), ident.data_ptr(), outs[0].data_ptr(),
                                   outs[1].data_ptr(), n, n, int(ident.dim() == 2), vec,
                                   stream)
    return run, outs, want, {"vec": vec, "rows_alive": int(alive.sum())}


def launch_floor(lib, n: int):
    """A launch of the empty kernel at the grid and block ``lib`` launches
    its kernel with at ``n`` (this tree's C entry points)."""
    import torch

    from kaboodle_tpu_torch.ops import _cuda

    blocks, threads = ctypes.c_int(), ctypes.c_int()
    lib.kb_launch_shape.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.kb_launch_shape.restype = None
    lib.kb_launch_shape(n, ctypes.byref(blocks), ctypes.byref(threads))
    lib.kb_empty_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.kb_empty_launch.restype = ctypes.c_int
    stream = _cuda.stream_handle(torch.device("cuda"))
    return lambda: lib.kb_empty_launch(blocks.value, threads.value, stream)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, help="root of another checkout")
    ap.add_argument("--probes", action="store_true", help="add the builds of PROBES")
    ap.add_argument("--rounds", type=int, default=3, help="timing rounds (at least 3)")
    args = ap.parse_args()
    if args.rounds < 3:
        ap.error("--rounds must be at least 3")

    import torch

    from chip_smoke import card_line, time_ms
    from kaboodle_tpu_torch.ops import _cuda

    if not torch.cuda.is_available():
        print("row_kernels_ab: no CUDA device is available", file=sys.stderr)
        return 2
    builds = {f"this_{s}": (s, ROOT / CSRC / f"{s}.cu") for s in SOURCES}
    if args.other:
        builds.update({f"other_{s}": (s, args.other.resolve() / CSRC / f"{s}.cu")
                       for s in SOURCES})
    if args.probes:
        builds.update(probe_sources(_cuda.BUILD_DIR / "row_ab_probes"))
    libs = build(builds)
    print(card_line(), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for kernel, n, dtype, cell, reps in SHAPES:
        source = "fused_suspicion" if kernel == "fused_suspicion" else "fused_fp"
        names = [b for b, (s, _) in builds.items() if s == source]
        run, outs, want, info = launcher(kernel, n, dtype, gen)
        for name in names:
            for o in outs:
                o.fill_(7)
            _cuda.check(libs[name], run(libs[name]), name)
            torch.cuda.synchronize()
            if not all(torch.equal(o, w) for o, w in zip(outs, want)):
                raise AssertionError(f"build {name} disagrees with the plain version: "
                                     f"{kernel} n={n} {dtype}")
        floor = launch_floor(libs[f"this_{source}"], n)
        times = {name: [] for name in names + ["launch_floor"]}
        for r in range(args.rounds):
            for name in names if r % 2 == 0 else names[::-1]:
                times[name].append(time_ms(lambda: run(libs[name]), reps))
            times["launch_floor"].append(time_ms(floor, reps))
        med = {name: statistics.median(t) for name, t in times.items()}
        other = med.get(f"other_{source}")
        line = {"kernel": kernel, "n": n, "timer": dtype, "cell": cell, **info,
                "launches_timed": reps, "bits_equal": True, "ms": times, "median_ms": med,
                "ratio": {name: m / other for name, m in med.items()} if other else None}
        print(json.dumps(line), flush=True)
        del run, outs, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
