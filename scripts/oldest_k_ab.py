#!/usr/bin/env python3
"""K4 builds side by side: ``csrc/fused_oldest_k.cu`` against another checkout's, or against probes.

    python3 scripts/oldest_k_ab.py [--other DIR] [--probes] [--churn-state]

``--other DIR`` adds the K4 source of another checkout's root, for example
the parent commit unpacked with ``git archive``. ``--probes`` adds builds
of this tree's source with one edit each (the table ``PROBES``): fewer
warps a block, the next chunk's loads started before the current chunk is
filtered -- the same function -- and two that
compute something else, to split the kernel's time: ``filter_only`` drops
the inserts (the filter still runs), ``loads_only`` also drops the filter
(the row's words are only loaded and folded into a register).
The entry point takes the row count and row offset of a row slice
(``n_rows, row0, n``), so ``--other`` needs a checkout that has them.

Every build is compiled with the flags of ``ops/_cuda.py`` (one nvcc each,
at once) and loaded with ctypes through the same C entry point. At the
shapes the main path launches K4 at (N = 16,384 int16 and N = 8,192 int32,
k = 5, inputs of ``chip_smoke.kernel_inputs``) and, with
``--churn-state``, on the final planes of ``chip_smoke``'s churn run, each
build is timed with CUDA events, in the order of the builds and then back,
and every build that computes K4 is checked bit-exact against the plain
version first. Prints the card line, then one JSON line per input with
each build's two times and ``records``: per alive row, how often a cell
undercuts every cell streamed before it in the kernel's order (the
inserts k = 1 makes; k = 5 makes more), mean and max. Needs a CUDA card
and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
SOURCE = Path("kaboodle_tpu_torch/csrc/fused_oldest_k.cu")

_INSERT = "  }\n  offer(key, bits, wl, lane);\n}"
_NO_INSERT = "  }\n  if (__any_sync(kFull, bits != 0)) wl.l ^= bits;\n}"
_FILTER = """  K key[kCells];
  unsigned bits = 0;
#pragma unroll
  for (int c = 0; c < kCells; ++c) {
    const int t = tv[c];
    key[c] = make_key<K>(t, j0 + c);
    bits |= static_cast<unsigned>(j0 < n && passes<K, kLo>(sv[c], t, key[c], tmax, lo, wl.thr))
            << c;
  }"""
_FOLD = """  unsigned bits = 0;
#pragma unroll
  for (int w = 0; w < kCells / 4; ++w) bits ^= reinterpret_cast<const unsigned*>(sv)[w];
#pragma unroll
  for (int w = 0; w < kCells * static_cast<int>(sizeof(TT)) / 4; ++w) {
    bits ^= reinterpret_cast<const unsigned*>(tv)[w];
  }"""
_AHEAD = """  Chunk<TT> cur = load_chunk(srow, trow, n, 0, lane);
  for (int q = 0; q < nchunks; q += 2) {
    const Chunk<TT> next = load_chunk(srow, trow, n, q + 1, lane);
    take_chunk<TT, K, kLo>(cur, q, n, row, tmax, lo, wl, lane);
    if (q + 1 >= nchunks) break;
    cur = load_chunk(srow, trow, n, q + 2, lane);
    take_chunk<TT, K, kLo>(next, q + 1, n, row, tmax, lo, wl, lane);
  }"""
_IN_TURN = """  for (int q = 0; q < nchunks; ++q) {
    take_chunk<TT, K, kLo>(load_chunk(srow, trow, n, q, lane), q, n, row, tmax, lo, wl, lane);
  }"""
# name: (edits as (old, new) pairs, computes K4)
PROBES = {
    "warps2": ([("constexpr int kWarps = 4;", "constexpr int kWarps = 2;")], True),
    "lookahead": ([(_IN_TURN, _AHEAD)], True),
    "filter_only": ([(_INSERT, _NO_INSERT)], False),
    "loads_only": ([(_INSERT, _NO_INSERT), (_FILTER, _FOLD)], False),
}


def probe_sources(out_dir: Path) -> dict[str, Path]:
    """Write each probe's source beside a copy of ``common.cuh``."""
    text = (ROOT / SOURCE).read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "common.cuh").write_text((ROOT / SOURCE.parent / "common.cuh").read_text())
    paths = {}
    for name, (edits, _) in PROBES.items():
        src = text
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"probe {name}: the source no longer has the text it edits")
            src = src.replace(old, new)
        paths[name] = out_dir / f"fused_oldest_k_{name}.cu"
        paths[name].write_text(src)
    return paths


def build(sources: dict[str, Path]) -> dict[str, ctypes.CDLL]:
    from kaboodle_tpu_torch.ops import _cuda
    from kaboodle_tpu_torch.ops.fused_oldest_k import _ARGTYPES

    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        out = _cuda.BUILD_DIR / f"liboldest_k_ab_{name}.so"
        cmd = [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-I", str(src.parent), "-o", str(out),
               str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {sources[name]}:\n{log}")
        lib = ctypes.CDLL(str(out))
        lib.kb_fused_oldest_k.argtypes = _ARGTYPES
        lib.kb_fused_oldest_k.restype = ctypes.c_int
        libs[name] = lib
    return libs


def records(state, timer, alive) -> dict:
    """Per alive row, the cells that undercut the lexicographic minimum of
    every eligible cell streamed before them, in the vec route's order
    (chunk, then a lane's cell slot, then lane)."""
    import torch

    from chip_smoke import oldest_k_key_plane

    n = state.shape[-1]
    j = torch.arange(n, device=state.device)
    order = torch.argsort((j // 512) * 512 + (j % 16) * 32 + (j % 512) // 16)
    keys = oldest_k_key_plane(state, timer, alive)[alive][:, order]
    if not keys.numel():
        return {}
    prev = torch.cummin(keys, dim=-1).values[:, :-1]
    first = keys[:, 0] != torch.iinfo(torch.int64).max
    c = (first + (keys[:, 1:] < prev).sum(-1)).to(torch.float64)
    return {"mean": float(c.mean()), "max": int(c.max())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, help="root of another checkout")
    ap.add_argument("--probes", action="store_true", help="add the builds of PROBES")
    ap.add_argument("--churn-state", action="store_true",
                    help="also time on the final planes of chip_smoke's churn run")
    args = ap.parse_args()

    import torch

    from chip_smoke import card_line, kernel_inputs, time_ms
    from kaboodle_tpu_torch.ops import _cuda
    from kaboodle_tpu_torch.ops.fused_oldest_k import fused_oldest_k_plain

    if not torch.cuda.is_available():
        print("oldest_k_ab: no CUDA device is available", file=sys.stderr)
        return 2
    sources, exact = {"this": ROOT / SOURCE}, {"this": True}
    if args.other:
        sources["other"], exact["other"] = args.other.resolve() / SOURCE, True
    if args.probes:
        for name, path in probe_sources(_cuda.BUILD_DIR / "oldest_k_probes").items():
            sources[name], exact[name] = path, PROBES[name][1]
    libs = build(sources)
    print(card_line(), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = [("boot", 16384, torch.int16), ("churn", 8192, torch.int32)]
    if args.churn_state:
        cases.append(("churn_final_state", 8192, torch.int32))
    order = list(libs) + list(libs)[::-1]
    for cell, n, dt in cases:
        k = 5
        if cell == "churn_final_state":
            from chip_smoke import churn_case

            _, make, run_churn = churn_case()
            final, _ = run_churn(make())
            state, timer, alive = final.state, final.timer, final.alive
            del final
        else:
            state, timer, alive, _ = kernel_inputs(n, dt, gen)
        want = fused_oldest_k_plain(state, timer, alive, k)
        idx = torch.empty((n, k), dtype=torch.int32, device="cuda")
        valid = torch.empty((n, k), dtype=torch.bool, device="cuda")
        vec = _cuda.vec_ok(n, state, timer)

        def run(lib):
            rc = lib.kb_fused_oldest_k(
                state.data_ptr(), timer.data_ptr(), timer.element_size(), alive.data_ptr(), k,
                idx.data_ptr(), valid.data_ptr(), n, 0, n, vec,
                _cuda.stream_handle(state.device))
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")

        times = {name: [] for name in libs}
        for name in order:
            if exact[name]:
                idx.fill_(-7)
                run(libs[name])
                torch.cuda.synchronize()
                if not (torch.equal(idx, want[0]) and torch.equal(valid, want[1])):
                    raise AssertionError(f"build {name} disagrees with the plain version at {cell}")
            times[name].append(time_ms(lambda: run(libs[name]), 20))
        rec = records(state, timer, alive)
        print(json.dumps({"cell": cell, "n": n, "timer": str(dt).replace("torch.", ""), "k": k,
                          "vec": vec, "rows_alive": int(alive.sum()), "ms": times,
                          "records": rec}), flush=True)
        del state, timer, alive, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
